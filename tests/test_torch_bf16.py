"""bfloat16 operands in every kernel family, on the CPU.

The JAX kernels take float32 and bfloat16 (``repro/kernels/guard/
preflight.py``; ``tests/test_kernels.py`` runs them in both). Their bf16
arithmetic: the operands read as stored, every product accumulated in
f32 (``preferred_element_type``), the cotangent rounded to the operand
type before the second product (``gw.astype(tile.dtype)``), and the
outputs in fixed types — losses in the inputs' type, the lse, scores,
counts and LSE pair f32, gradients in the operands' types. The port's
CUDA kernels widen a bf16 operand to f32 where it lands and compute the
same function; a kernel has no CPU mode, so here:

- the plain versions (``kernels/ref.py``, the CPU path of ``ops``) on
  bf16 inputs made with numpy against the JAX kernels in Pallas interpret
  mode on the same inputs, per family, at a resident depth (32) and a
  deep one (288): ``mips_topk``, ``eval_fused`` / ``eval_tgt_gather``,
  ``sce_gather_loss`` / ``sce_gather_plse`` and their ``sce_bucket``
  twins (forward and gradients), ``linear_ce_loss`` and ``fused_lse`` /
  ``fused_ce_loss`` (forward and gradients). Tolerance: ``3e-2`` of each
  tensor's largest magnitude (the reference's own bf16 tolerance in
  ``tests/test_kernels.py``; the JAX kernels add their dY partials in
  bf16 and the port rounds once, and a cotangent on a rounding tie may
  round either way), ids equal wherever a row's neighbouring values lie
  further apart than that, counts equal on integer inputs, and the
  output types equal the reference's;
- a plain model of the card's bf16 product (``csrc/deep_tc.cuh``: the
  value split into TF32 ``(hi, lo)``, each k16 step's passes from zero,
  added in f32): on bf16 values one hi·hi pass equals the three passes
  on their f32 copies bit for bit, within f32 rounding of f64; the
  backward's model (widen, accumulate in f32, round G to bf16) against
  f64 and against the JAX kernels' VJP;
- the type rule every wrapper applies (``deep.operand_dtype``): a bf16 /
  f32 mix, float64 and float16 raise.

gemma-2's smoke LM step in bf16 against the reference's is in
``tests/test_torch_lm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import eval_fused as jeval
from repro.kernels import fused_ce as jfused
from repro.kernels import guard as jguard
from repro.kernels import linear_sce as jlinear
from repro.kernels import mips_topk as jmips
from repro.kernels import sce_bucket as jbucket
from repro.kernels import sce_prefetch as jsce
from repro_torch.kernels import deep, ref

DEPTHS = [32, 288]  # resident, deep
TOL = 3e-2
BF = torch.bfloat16


def _bf16(rng, *shape, scale=1.0):
    """A standard normal array rounded to bfloat16: the torch tensor and
    the jax array of the same values."""
    a = torch.from_numpy((scale * rng.standard_normal(shape))
                         .astype(np.float32)).to(BF)
    return a, jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)


def _ints(rng, *shape):
    a = torch.from_numpy(rng.integers(-2, 3, shape).astype(np.float32)).to(BF)
    return a, jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)


def _np(a):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    if isinstance(a, torch.Tensor):
        return a.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def _close(got, want, tol=TOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    err = np.abs(g - w).max()
    assert err <= tol * np.abs(w).max(), (err, np.abs(w).max())


def _same_type(got, want):
    """A torch output's type against the JAX output's."""
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)


def _ids_match(gv, gi, wv, wi, tol):
    gv, wv = _np(gv), _np(wv)
    gi, wi = np.asarray(gi), np.asarray(wi)
    assert np.abs(gv - wv).max() <= tol
    prv = np.concatenate([np.full_like(wv[:, :1], np.inf), wv[:, :-1]], 1)
    nxt = np.concatenate([wv[:, 1:], np.full_like(wv[:, :1], -np.inf)], 1)
    iso = ((prv - wv) > tol) & ((wv - nxt) > tol)
    assert iso.any() and np.array_equal(gi[iso], wi[iso])


@pytest.mark.parametrize("d", DEPTHS)
@pytest.mark.parametrize("k", [10, 40])
def test_bf16_plain_mips_topk_matches_jax_kernel(d, k):
    rng = np.random.default_rng(d + k)
    q, jq = _bf16(rng, 6, d)
    y, jy = _bf16(rng, 203, d)
    want = jmips.mips_topk(jq, jy, k, block_q=8, block_c=64, interpret=True)
    got = ref.mips_topk_ref(q, y, k, chunk=64)
    _same_type(got[0], want[0])
    _same_type(got[1], want[1])
    scale = np.abs(_np(q) @ _np(y).T).max()
    _ids_match(got[0], got[1], want[0], want[1], 1e-5 * scale)


@pytest.mark.parametrize("d", DEPTHS)
@pytest.mark.parametrize("k,with_lse", [(1, True), (10, False)])
def test_bf16_plain_eval_fused_matches_jax_kernel(d, k, with_lse):
    """Integer bf16 inputs (exact sums): ids, values, gt, eq and the
    target score equal the JAX kernels' (interpret mode), eval_tgt_gather
    too; the LSE (cap 30) within 1e-5 relative; the types equal."""
    rng = np.random.default_rng(d + 7 * k)
    x, jx = _ints(rng, 6, d)
    y, jy = _ints(rng, 200, d)
    t = rng.integers(1, 190, 6).astype(np.int32)
    kw = dict(c_lo=1, c_hi=190, with_lse=with_lse,
              logit_softcap=30.0 if with_lse else None)
    jguard.set_policy("off")  # its CPU canaries fail (ROADMAP queue 3)
    try:
        want = jeval.eval_fused(jx, jy, jnp.asarray(t), k, block_b=8,
                                block_c=64, interpret=True, **kw)
        wtgt = jeval.eval_tgt_gather(jx, jy, jnp.asarray(t), block_b=8,
                                     block_c=64, interpret=True)
    finally:
        jguard.set_policy(None)
    tt = torch.from_numpy(t)
    got = ref.eval_fused_ref(x, y, tt, k, chunk=64, **kw)
    for a, b in zip(got[:5], want[:5]):
        _same_type(a, b)
        assert np.array_equal(a.numpy(), np.asarray(b))
    tgt = ref.eval_tgt_gather_ref(x, y, tt, chunk=64)
    _same_type(tgt, wtgt)
    assert np.array_equal(tgt.numpy(), np.asarray(wtgt))
    if with_lse:
        _same_type(got[5], want[5])
        lse = (got[5] + torch.log(got[6])).numpy()
        wlse = np.asarray(want[5]) + np.log(np.asarray(want[6]))
        np.testing.assert_allclose(lse, wlse, rtol=1e-5, atol=0)


def _sce_problem(seed, n_b, b_x, b_y, d, c):
    rng = np.random.default_rng(seed)
    x_b = _bf16(rng, n_b, b_x, d, scale=0.5)
    y = _bf16(rng, c, d, scale=0.5)
    idx = rng.integers(0, c, (n_b, b_y)).astype(np.int32)
    tgt = rng.integers(0, c, (n_b, b_x)).astype(np.int32)
    cand = idx.copy()
    cand[:, 0] = tgt[:, 0]
    cand[:, -1] = -1
    pos = _bf16(rng, n_b, b_x)
    g = rng.random((n_b, b_x)).astype(np.float32)
    return x_b, y, idx, tgt, cand, pos, g


def _port_grads(fn, leaves, g):
    ls = [t.clone().requires_grad_(True) for t in leaves]
    out = fn(*ls)
    return out, torch.autograd.grad((out.float() * torch.from_numpy(g))
                                    .sum(), ls)


def _jax_grads(fn, leaves, g):
    def f(*a):
        out = fn(*a)
        return jnp.sum(out.astype(jnp.float32) * g), out
    (_, out), grads = jax.value_and_grad(
        f, tuple(range(len(leaves))), has_aux=True)(*leaves)
    return out, grads


def _check(port, jax_):
    (out, grads), (wout, wgrads) = port, jax_
    _same_type(out, wout)
    _close(out, wout)
    for a, b in zip(grads, wgrads):
        _same_type(a, b)
        _close(a, b)


@pytest.mark.parametrize("d", DEPTHS)
@pytest.mark.parametrize("cap", [None, 30.0])
def test_bf16_plain_sce_gather_matches_jax_kernel(d, cap):
    """The loss (gradients of x_b, y and pos) and the partial LSE
    (gradients of x_b and y) against the JAX kernels' VJPs."""
    (x_b, jx), (y, jy), idx, tgt, cand, (pos, jpos), g = _sce_problem(
        d + int(cap or 0), 2, 16, 24, d, 100)
    ti, tt, tc = (torch.from_numpy(a) for a in (idx, tgt, cand))
    _check(_port_grads(lambda a, b, p: ref.sce_gather_loss_ref(
               a, b, ti, tt, tc, p, cap), (x_b, y, pos), g),
           _jax_grads(lambda a, b, p: jsce.sce_gather_loss(
               a, b, idx, tgt, cand, p, 16, 16, True, cap),
               (jx, jy, jpos), g))
    _check(_port_grads(lambda a, b: ref.sce_gather_plse_ref(
               a, b, ti, tt, tc, cap), (x_b, y), g),
           _jax_grads(lambda a, b: jsce.sce_gather_plse(
               a, b, idx, tgt, cand, 16, 16, True, cap), (jx, jy), g))


@pytest.mark.parametrize("d", DEPTHS)
def test_bf16_plain_sce_bucket_matches_jax_kernel(d):
    (x_b, jx), (y, jy), idx, tgt, cand, (pos, jpos), g = _sce_problem(
        d + 1, 2, 16, 24, d, 100)
    y_b = y[torch.from_numpy(idx).long()]
    jy_b = jnp.take(jy, idx, axis=0)
    tt, tc = torch.from_numpy(tgt), torch.from_numpy(cand)
    _check(_port_grads(lambda a, b, p: ref.sce_bucket_loss_ref(
               a, b, tt, tc, p, 30.0), (x_b, y_b, pos), g),
           _jax_grads(lambda a, b, p: jbucket.sce_bucket_loss(
               a, b, tgt, cand, p, 16, 16, True, 30.0), (jx, jy_b, jpos), g))
    _check(_port_grads(lambda a, b: ref.sce_bucket_plse_ref(
               a, b, tt, tc, None), (x_b, y_b), g),
           _jax_grads(lambda a, b: jbucket.sce_bucket_plse(
               a, b, tgt, cand, 16, 16, True, None), (jx, jy_b), g))


def _ce_problem(seed, n, c, d):
    rng = np.random.default_rng(seed)
    x = _bf16(rng, n, d)
    w = _bf16(rng, c, d, scale=0.5)
    t = rng.integers(0, c, n).astype(np.int32)
    g = (rng.random(n) + 0.5).astype(np.float32)
    return x, w, t, g


@pytest.mark.parametrize("d", DEPTHS)
@pytest.mark.parametrize("cap", [None, 30.0])
def test_bf16_plain_linear_ce_matches_jax_kernel(d, cap):
    (x, jx), (w, jw), t, g = _ce_problem(d + 3, 40, 300, d)
    tt = torch.from_numpy(t)
    _check(_port_grads(lambda a, b: ref.linear_ce_loss_ref(
               a, b, tt, logit_softcap=cap, chunk=128), (x, w), g),
           _jax_grads(lambda a, b: jlinear.linear_ce_loss(
               a, b, jnp.asarray(t), cap, 16, 128, True), (jx, jw), g))


@pytest.mark.parametrize("d", DEPTHS)
def test_bf16_plain_fused_ce_matches_jax_kernel(d):
    """fused_lse (f32 lse, the reference's) and fused_ce_loss (in x's
    type), with their gradients."""
    (x, jx), (w, jw), t, g = _ce_problem(d + 5, 40, 300, d)
    tt = torch.from_numpy(t)
    _check(_port_grads(lambda a, b: ref.fused_lse_ref(a, b, chunk=128),
                       (x, w), g),
           _jax_grads(lambda a, b: jfused.fused_lse(a, b, 16, 128, True),
                      (jx, jw), g))
    _check(_port_grads(lambda a, b: ref.fused_ce_loss_ref(a, b, tt,
                                                          chunk=128),
                       (x, w), g),
           _jax_grads(lambda a, b: jfused.fused_ce_loss(
               a, b, jnp.asarray(t), 16, 128, True), (jx, jw), g))


# -- a plain model of the card's bf16 arithmetic ------------------------------
def _split(a):
    hi = ref.tf32_round(a)
    return hi, ref.tf32_round(a - hi)


def _three_pass(a, b):
    """``a (M, K) · b (N, K)ᵀ`` as ``deep_tc.cuh`` takes f32 operands: the
    split, per k16 step lo·hi + hi·lo + hi·hi from zero (each product
    exact in f32), the step added to the f32 total."""
    ah, al = _split(a)
    bh, bl = (t.T for t in _split(b))
    out = torch.zeros(a.shape[0], b.shape[0])
    for k in range(0, a.shape[1], 16):
        s = slice(k, k + 16)
        out += ((al[:, s] @ bh[s] + ah[:, s] @ bl[s]) + ah[:, s] @ bh[s])
    return out


def _one_pass(a, b):
    """The same for bf16 operands: widened, each its own hi; one pass."""
    a, b = a.float(), b.float()
    out = torch.zeros(a.shape[0], b.shape[0])
    for k in range(0, a.shape[1], 16):
        s = slice(k, k + 16)
        out += a[:, s] @ b[:, s].T
    return out


@pytest.mark.parametrize("m,n,k", [(37, 29, 300), (20, 24, 2304)])
def test_bf16_one_pass_equals_three_passes_on_the_widened_values(m, n, k):
    rng = np.random.default_rng(m + n + k)
    a, _ = _bf16(rng, m, k)
    b, _ = _bf16(rng, n, k)
    aw, bw = a.float(), b.float()
    assert (_split(aw)[1] == 0).all() and (_split(bw)[1] == 0).all()
    one = _one_pass(a, b)
    assert torch.equal(one, _three_pass(aw, bw))
    want = aw.double() @ bw.double().T
    assert ((one.double() - want).abs()
            <= 1e-5 * want.abs().max() + 2e-6 * want.abs()).all()


@pytest.mark.parametrize("d", DEPTHS)
def test_bf16_backward_model_rounds_the_cotangent(d):
    """The card's full-CE backward on bf16 operands, modelled: logits of
    the widened values, G = (exp(l − lse) − onehot)·g in f32, rounded to
    bf16, then dX = G·W and dW = Gᵀ·X accumulated in f32 and rounded to
    bf16 once. ``ref.linear_ce_dx_ref`` / ``_dw_ref`` compute that model;
    it lies within bf16 rounding of f64 and within the tolerance of the
    JAX kernels' VJP (interpret mode)."""
    (x, jx), (w, jw), t, g = _ce_problem(d + 11, 40, 300, d)
    tt, gt = torch.from_numpy(t), torch.from_numpy(g)
    lse = ref.fused_lse_ref(x, w)
    dx = ref.linear_ce_dx_ref(x, w, tt, lse, gt).to(BF)
    dw = ref.linear_ce_dw_ref(x, w, tt, lse, gt).to(BF)
    xd, wd = x.double(), w.double()
    p = torch.softmax(xd @ wd.T, -1)
    gw = (p - torch.nn.functional.one_hot(tt.long(), w.shape[0])) \
        * gt.double()[:, None]
    for got, want in ((dx, gw @ wd), (dw, gw.T @ xd)):
        err = (got.double() - want).abs()
        # one bf16 rounding of G (2⁻⁹ relative) and of the sum
        assert (err <= 2 ** -7 * want.abs().max()).all()
    _, (wdx, wdw) = _jax_grads(lambda a, b: jlinear.linear_ce_loss(
        a, b, jnp.asarray(t), None, 16, 128, True), (jx, jw), g)
    _close(dx, wdx)
    _close(dw, wdw)


@pytest.mark.parametrize("a,b,ok", [
    (torch.float32, torch.float32, True),
    (BF, BF, True),
    (BF, torch.float32, False),
    (torch.float32, BF, False),
    (torch.float64, torch.float64, False),
    (torch.float16, torch.float16, False),
])
def test_operand_types_are_f32_or_bf16_and_never_mixed(a, b, ok):
    x, y = torch.zeros(2, 4, dtype=a), torch.zeros(3, 4, dtype=b)
    if ok:
        assert deep.operand_dtype("k", x, y) == a
        assert deep.bf16_flag(a) == (a == BF)
    else:
        with pytest.raises(TypeError):
            deep.operand_dtype("k", x, y)

