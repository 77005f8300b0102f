"""The arithmetic of the deep variants on ``csrc/deep_tc.cuh``, on the CPU.

Above d = 256 the full-CE kernels (``linear_ce_loss``, ``fused_lse``,
``fused_ce_loss``) and the in-bucket SCE kernels run their deep entries,
whose every product is ``deep_tc.cuh``'s: each f32 input split into
``hi = tf32(a)`` and ``lo = tf32(a − hi)``, each product
``lo·hi + hi·lo + hi·hi``, each k16 step of a sum from zero and added to
an f32 total in ascending depth. The full CE walks the catalog in chunks
(``linear_sce.deep_chunk`` rows): per chunk the logits slab, then the
forward's fold (the softcap, the online ``(m, s)`` merged after the
chunks before it, the target's logit plucked in its chunk) or the
backward's cotangent ``(exp(min(l − lse, 44)) − onehot)·cap′·g``, split
again, with dX accumulated over the chunks in order and dW's chunk rows
written once. A CUDA kernel has no CPU mode, so this file holds plain
models of that arithmetic (test-only) as evidence before the card:

- the product's model within ``1e-5·max|C| + 2e-4·|C|`` of f64 at ragged
  shapes up to gemma-2's d 2304, with the accumulate epilogue;
- the deep full-CE model (forward, dX, dW) at d 288 and 300, ragged N and
  C in ragged chunks, a target in the last chunk and targets outside
  ``[0, C)``: against the plain versions evaluated in f64, and against
  the JAX kernels ``linear_ce_loss`` (cap 30 and none) and ``fused_lse`` /
  ``fused_ce_loss`` in interpret mode (their VJPs too);
- the deep SCE model (the logits, the masked online fold, dX and dY from
  one cotangent) at d 288 and 300 against the JAX ``sce_gather_plse`` and
  ``sce_gather_loss`` (interpret mode, values and VJPs);
- ``deep_chunk``: whole 128-row tiles inside the slab budget, no more
  than the catalog;
- gemma-2's smoke LM step at d 288 with ``train_loss="ce_fused_linear"``,
  the port's full CE running the deep model (patched in for the CPU's
  plain path), against the reference's step (its Pallas kernel in
  interpret mode) on the same parameters and batches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_ce as jfused
from repro.kernels import linear_sce as jlinear
from repro.kernels import ops as jops
from repro_torch.kernels import deep, linear_sce, ref

MAX_EXP = 44.0  # the kernels' cap on exp's argument
NEG_INF = -1e30


def _split(a):
    hi = ref.tf32_round(a)
    return hi, ref.tf32_round(a - hi)


def _product(a, b):
    """``a (…, M, K) · b (…, N, K)ᵀ`` as ``deep_tc.cuh`` takes it: split
    operands, per k16 step the three TF32 products from zero (each exact
    in f32: 11 by 11 bits), the step added to the f32 total."""
    ah, al = _split(a)
    bh, bl = (t.transpose(-1, -2) for t in _split(b))
    out = torch.zeros(*a.shape[:-1], b.shape[-2])
    for k in range(0, a.shape[-1], 16):
        s = slice(k, k + 16)
        out += ((al[..., s] @ bh[..., s, :] + ah[..., s] @ bl[..., s, :])
                + ah[..., s] @ bh[..., s, :])
    return out


def _close(got, want, rtol=2e-4):
    got, want = torch.as_tensor(np.asarray(got)), torch.as_tensor(
        np.asarray(want))
    assert got.shape == want.shape and torch.isfinite(got).all()
    tol = 1e-5 * want.abs().max().item()
    err = (got - want.to(got.dtype)).abs()
    assert (err <= tol + rtol * want.abs()).all(), err.max().item()


# -- the product -------------------------------------------------------------
@pytest.mark.parametrize("m,n,k", [(37, 29, 300), (5, 7, 37), (20, 24, 2304)])
def test_product_model_holds_f64(m, n, k):
    rng = np.random.default_rng(m + n + k)
    a = torch.from_numpy(rng.standard_normal((2, m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, n, k)).astype(np.float32))
    out0 = torch.from_numpy(rng.standard_normal((2, m, n)).astype(np.float32))
    want = ref.deep_tc_ref(a.double(), b.double())
    _close(_product(a, b), want)
    _close(out0 + _product(a, b), ref.deep_tc_ref(
        a.double(), b.double(), out=out0.double()))


def test_plain_product_takes_every_operand_option():
    """``ref.deep_tc_ref`` — the plain version the CUDA tests hold the
    kernel to — reads A M-major, B N-major and B gathered by clamped id as
    the layouts say, and zeroes C's rows before the accumulate."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2, 5, 7)))
    tab = torch.from_numpy(rng.standard_normal((10, 7)))
    idx = torch.tensor([[0, 3, 12, -1], [1, 2, 3, 9]], dtype=torch.int32)
    want = torch.einsum("tmk,tnk->tmn", a, tab[idx.long().clamp(0, 9)])
    assert torch.allclose(ref.deep_tc_ref(a, tab, idx=idx), want)
    assert torch.allclose(ref.deep_tc_ref(
        a.transpose(1, 2).contiguous(), tab[idx.long().clamp(0, 9)]
        .transpose(1, 2).contiguous(), a_km=True, b_kn=True), want)
    tab_n = torch.from_numpy(rng.standard_normal((10, 4)))
    idx_k = torch.from_numpy(rng.integers(-1, 11, (2, 7)).astype(np.int32))
    want_kn = torch.einsum("tmk,tkn->tmn", a,
                           tab_n[idx_k.long().clamp(0, 9)])
    assert torch.allclose(ref.deep_tc_ref(a, tab_n, b_kn=True, idx=idx_k),
                          want_kn)
    zero = torch.tensor([[0, -1, 2, -5, 1], [-1, 0, 0, 0, 0]],
                        dtype=torch.int32)
    out0 = torch.ones(2, 5, 4)
    got = ref.deep_tc_ref(a, tab, idx=idx, m_zero=zero, out=out0)
    assert torch.equal(got[zero < 0], out0[zero < 0].double())


# -- the deep full CE --------------------------------------------------------
def _ce_forward(x, w, targets, cap, chunk):
    """``(loss or None, lse)`` in the deep forward's arithmetic."""
    n, c = x.shape[0], w.shape[0]
    m = torch.full((n,), NEG_INF)
    s = torch.zeros(n)
    pos = torch.zeros(n)
    for c0 in range(0, c, chunk):
        lg = _product(x, w[c0:c0 + chunk])
        if cap is not None:
            lg = cap * torch.tanh(lg / cap)
        mc = lg.amax(1)
        sc = torch.exp(lg - mc[:, None]).sum(1)
        mn = torch.maximum(m, mc)
        s = s * torch.exp(m - mn) + sc * torch.exp(mc - mn)
        m = mn
        if targets is not None:
            t = targets.long() - c0
            hit = (t >= 0) & (t < lg.shape[1])
            pos = torch.where(hit, lg.gather(
                1, t.clamp(0, lg.shape[1] - 1)[:, None])[:, 0], pos)
    lse = m + torch.log(s)
    return (None if targets is None else lse - pos), lse


def _ce_backward(x, w, targets, lse, g, cap, chunk):
    """``(dX, dW)`` in the deep backward's arithmetic: per chunk the
    logits, the cotangent in f32, dX accumulated in chunk order, dW's
    chunk rows."""
    c = w.shape[0]
    dx = torch.zeros_like(x)
    dw = torch.empty_like(w)
    for c0 in range(0, c, chunk):
        wc = w[c0:c0 + chunk]
        lg = _product(x, wc)
        if cap is not None:
            lg = cap * torch.tanh(lg / cap)
        p = torch.exp(torch.clamp(lg - lse[:, None], max=MAX_EXP))
        if targets is not None:
            cols = torch.arange(c0, c0 + wc.shape[0])[None, :]
            p = p - (cols == targets.long()[:, None]).float()
        if cap is not None:
            p = p * (1.0 - (lg / cap) ** 2)
        gw = p * g[:, None]
        dx += _product(gw, wc.T.contiguous())
        dw[c0:c0 + wc.shape[0]] = _product(gw.T.contiguous(),
                                           x.T.contiguous())
    return dx, dw


def _ce_problem(n, c, d, chunk):
    """x at 2·randn, w at randn / 4 (logits of ≈ sqrt(d)/2), a target in
    the last (ragged) chunk, rows 1 and 2 targeting −1 and C + 3, every
    third cotangent 0."""
    assert c % chunk and c > chunk
    rng = np.random.default_rng(n + c + d)
    x = (2.0 * rng.standard_normal((n, d))).astype(np.float32)
    w = (rng.standard_normal((c, d)) / 4).astype(np.float32)
    t = rng.integers(0, c, n).astype(np.int32)
    t[0] = c - 1
    t[1], t[2] = -1, c + 3
    g = rng.uniform(0.5, 1.5, n).astype(np.float32)
    g[::3] = 0.0
    return x, w, t, g


CE_CASES = [(37, 1_000, 288, 256), (21, 700, 300, 128)]


@pytest.mark.parametrize("n,c,d,chunk", CE_CASES)
@pytest.mark.parametrize("cap", [None, 30.0])
def test_deep_ce_model_holds_f64(n, c, d, chunk, cap):
    x, w, t, g = map(torch.from_numpy, _ce_problem(n, c, d, chunk))
    xd, wd = x.double(), w.double()
    loss, lse = _ce_forward(x, w, t, cap, chunk)
    _close(loss, ref.linear_ce_loss_ref(xd, wd, t, logit_softcap=cap),
           rtol=0.0)
    _close(lse, ref.fused_lse_ref(xd, wd, logit_softcap=cap), rtol=0.0)
    assert torch.allclose(loss[1:3], lse[1:3], rtol=0, atol=0)
    dx, dw = _ce_backward(x, w, t, lse, g, cap, chunk)
    exact = (xd, wd, t, lse.double(), g.double())
    _close(dx, ref.linear_ce_dx_ref(*exact, logit_softcap=cap))
    _close(dw, ref.linear_ce_dw_ref(*exact, logit_softcap=cap))
    assert (dx[g == 0] == 0).all()


@pytest.mark.parametrize("n,c,d,chunk", CE_CASES)
@pytest.mark.parametrize("cap", [None, 30.0])
def test_deep_linear_ce_model_matches_the_jax_kernel(n, c, d, chunk, cap):
    """``linear_ce_loss`` (interpret mode, 16-row by 128-column blocks):
    the loss and its VJP in x and w. Row 2 targets a real column here:
    the JAX kernel plucks a target in its last block's padding (C + 3)
    from a NEG_INF column, where the port's contract plucks 0."""
    x, w, t, g = _ce_problem(n, c, d, chunk)
    t[2] = c - 2
    want, vjp = jax.vjp(
        lambda a, b: jlinear.linear_ce_loss(a, b, jnp.asarray(t), cap, 16,
                                            128, True),
        jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt, wt, tt, gt = map(torch.from_numpy, (x, w, t, g))
    loss, lse = _ce_forward(xt, wt, tt, cap, chunk)
    _close(loss, want, rtol=0.0)
    dx, dw = _ce_backward(xt, wt, tt, lse, gt, cap, chunk)
    _close(dx, want_dx)
    _close(dw, want_dw)


@pytest.mark.parametrize("n,c,d,chunk", CE_CASES)
@pytest.mark.parametrize("family", ["fused_lse", "fused_ce"])
def test_deep_fused_model_matches_the_jax_kernel(n, c, d, chunk, family):
    """``fused_lse`` and ``fused_ce_loss`` (interpret mode; no cap, no
    pluck in the kernels; the fused loss gathers the positive outside):
    values and VJPs."""
    x, w, t, g = _ce_problem(n, c, d, chunk)
    t = np.clip(t, 0, c - 1)
    if family == "fused_lse":
        f = lambda a, b: jfused.fused_lse(a, b, 16, 128, True)  # noqa: E731
    else:
        f = lambda a, b: jfused.fused_ce_loss(  # noqa: E731
            a, b, jnp.asarray(t), 16, 128, True)
    want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt, wt, tt, gt = map(torch.from_numpy, (x, w, t, g))
    _, lse = _ce_forward(xt, wt, None, None, chunk)
    dx, dw = _ce_backward(xt, wt, None, lse, gt, None, chunk)
    if family == "fused_ce":  # − x·w[t]: its gradient outside the kernels
        lse = lse - (xt * wt[tt.long()]).sum(1)
        dx = dx - gt[:, None] * wt[tt.long()]
        dw = dw.index_add(0, tt.long(), -gt[:, None] * xt)
    _close(lse, want, rtol=0.0)
    _close(dx, want_dx)
    _close(dw, want_dw)


def test_deep_chunk_fills_the_slab_budget():
    # the score slab's sizer (deep.slab_rows) with the catalog rows a
    # multiple of 4 (16-byte rows of the f32 slab), of 128 from 128 up
    for n, c in ((4_096, 256_000), (8_192, 256_000), (37, 1_000),
                 (100_000, 256_000), (4_096, 100), (5_000_000, 256_000)):
        chunk = linear_sce.deep_chunk(n, c)
        assert chunk % 4 == 0 and chunk >= 4
        whole = -(-c // 4) * 4  # the whole catalog in one chunk
        assert chunk <= whole
        assert (chunk == whole or chunk < deep.SLAB_ALIGN
                or chunk % deep.SLAB_ALIGN == 0)
        assert 4 * n * chunk <= deep.SLAB_BYTES or chunk == 4
    assert linear_sce.deep_chunk(4_096, 256_000) == 65_536
    assert not linear_sce.is_deep(256) and linear_sce.is_deep(257)


# -- the deep SCE ------------------------------------------------------------
def _sce_problem(n_b, b_x, b_y, d, c, plse):
    rng = np.random.default_rng(n_b + b_x + b_y + d + plse)
    x_b = (2.0 * rng.standard_normal((n_b, b_x, d))).astype(np.float32)
    y = (rng.standard_normal((c, d)) / 4).astype(np.float32)
    idx = rng.integers(0, c, (n_b, b_y)).astype(np.int32)
    tgt = rng.integers(0, c, (n_b, b_x)).astype(np.int32)
    cand = idx.copy()
    cand[:, 0] = tgt[:, 0]
    cand[:, -1] = -1
    if plse:
        cand[:, 1::3] = -1
    pos = rng.standard_normal((n_b, b_x)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (n_b, b_x)).astype(np.float32)
    return x_b, y, idx, tgt, cand, pos, g


def _sce_model(x_b, y, idx, tgt, cand, pos, g, cap):
    """``(out, dX, dY)`` in the deep SCE arithmetic: the logits into the
    workspace by the product (candidates gathered by clamped id), the
    softcap, the mask; the fold ((pos, 1) first for the loss, the plse
    from (NEG_INF, 0) without); the cotangent once, split again, dX and
    dY's slot rows from it, dY's rows summed into the catalog."""
    rows = idx.long().clamp(0, y.shape[0] - 1)
    y_b = y[rows]
    lg = _product(x_b, y_b)
    if cap is not None:
        lg = cap * torch.tanh(lg / cap)
    masked = (cand[:, None, :] < 0) | (cand[:, None, :] == tgt[:, :, None])
    lv = torch.where(masked, NEG_INF, lg)
    if pos is None:
        m = lv.amax(-1)
        s = torch.where(masked, 0.0, torch.exp(lv - m[..., None])).sum(-1)
        lse = m + torch.log(torch.clamp(s, min=1e-30))
        out = lse
    else:
        m = torch.maximum(lv.amax(-1), pos)
        s = (torch.where(masked, 0.0, torch.exp(lv - m[..., None])).sum(-1)
             + torch.exp(pos - m))
        lse = m + torch.log(s)
        out = lse - pos
    p = torch.exp(torch.clamp(lg - lse[..., None], max=MAX_EXP))
    if cap is not None:
        p = p * (1.0 - (lg / cap) ** 2)
    gw = torch.where(masked, 0.0, p * g[..., None])
    dx = _product(gw, y_b.transpose(1, 2).contiguous())
    dy_b = _product(gw.transpose(1, 2).contiguous(),
                    x_b.transpose(1, 2).contiguous())
    dy_b = torch.where((cand < 0)[..., None], 0.0, dy_b)
    dy = torch.zeros_like(y).index_add_(0, rows.reshape(-1),
                                        dy_b.reshape(-1, y.shape[1]))
    return out, dx, dy


@pytest.mark.parametrize("d", [288, 300])
@pytest.mark.parametrize("plse,cap", [(True, 30.0), (True, None),
                                      (False, 30.0)])
def test_deep_sce_model_matches_the_jax_kernel(d, plse, cap):
    x_b, y, idx, tgt, cand, pos, g = _sce_problem(2, 20, 40, d, 90, plse)
    kw = dict(block_bx=16, block_by=16, interpret=True, logit_softcap=cap)

    def f(a, b):
        if plse:
            return jops.sce_gather_plse(a, b, idx, tgt, cand, **kw)
        return jops.sce_gather_loss(a, b, idx, tgt, cand, pos, **kw)

    want, vjp = jax.vjp(f, jnp.asarray(x_b), jnp.asarray(y))
    want_dx, want_dy = vjp(jnp.asarray(g))
    t = [torch.from_numpy(a) for a in (x_b, y, idx, tgt, cand, pos, g)]
    if plse:
        t[5] = None
    out, dx, dy = _sce_model(*t, cap)
    _close(out, want, rtol=0.0)
    _close(dx, want_dx)
    _close(dy, want_dy)


# -- gemma-2's LM step with the deep full CE ---------------------------------
class _DeepLinearCE(torch.autograd.Function):
    """The deep model as the port's CPU full CE: its forward and its
    backward (chunks of 128 catalog rows)."""

    @staticmethod
    def forward(ctx, x, w, targets, cap):
        loss, lse = _ce_forward(x, w, targets, cap, 128)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.cap = cap
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        dx, dw = _ce_backward(x, w, targets, lse, g.contiguous(), ctx.cap,
                              128)
        return dx, dw, None, None


def test_lm_step_on_the_deep_full_ce_matches_reference(monkeypatch):
    """gemma-2's smoke config at d_model 288 with ``train_loss=
    "ce_fused_linear"`` (softcap 30, vocabulary 1,024 in 8 chunks): two
    steps of the port's ``make_lm_train_step`` whose full CE runs the deep
    model against two of the reference's (its ``linear_ce_loss`` kernel in
    interpret mode), from the same parameters on the same batches: losses
    within 2e-5 and gradient norms within 1e-4, relative."""
    import test_torch_lm as lm

    from repro_torch.kernels import guard

    calls = []

    def deep(x, w, targets, *, logit_softcap=None, chunk=512):
        calls.append(x.shape)
        return _DeepLinearCE.apply(x.float(), w.float(),
                                   targets.to(torch.int32), logit_softcap)

    monkeypatch.setattr(ref, "linear_ce_loss_ref", deep)
    jarch, jcfg, arch, cfg = lm._configs()
    jcfg = dataclasses.replace(jcfg, d_model=288)
    cfg = dataclasses.replace(cfg, d_model=288)
    jarch = dataclasses.replace(jarch, train_loss="ce_fused_linear")
    arch = dataclasses.replace(arch, train_loss="ce_fused_linear")
    guard.set_policy("off")
    try:
        rows = lm._run_both(jarch, jcfg, arch, cfg, n_steps=2)
    finally:
        guard.set_policy(None)
    assert calls and all(s[1] == 288 for s in calls)
    lm._check_steps(rows)
