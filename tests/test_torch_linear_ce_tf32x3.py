"""The arithmetic of the 3xTF32 full-CE kernels, on the CPU.

``csrc/linear_ce.cu``'s forward, dX and dW/dY kernels take their products
on the tensor cores in 3xTF32 (``csrc/tf32x3_tile.cuh``): each f32 input
is split into ``hi = tf32(a)`` and ``lo = tf32(a − hi)``
(``cvt.rna.tf32.f32``), each product is ``lo·hi + hi·lo + hi·hi``, and
each k16 step of a sum starts from zero and is added to an f32 total. A
CUDA kernel has no CPU mode, so this file holds plain models of that
arithmetic (``_tf32x3_forward`` and ``_tf32x3_backward``, test-only)
against the plain versions, as evidence before the card that the chip
tolerance holds:

- ``ref.tf32_round`` (the plain ``cvt.rna.tf32.f32``) on values built bit
  by bit: ties away from zero, carries into the exponent, subnormals,
  inf and NaN; integers below 2¹¹ split exactly (``lo = 0``);
- ``ref.tf32x3_planes_ref`` (the plain split kernel): the (hi, lo) layout,
  zeros past d, 22 bits of every value;
- the forward model's loss (the target's logit plucked from the logits
  that enter the sum) and lse on small versions of the five cases of
  ``test_torch_cuda.py::test_linear_ce_kernels_match_plain`` (cap 30 and
  none, ragged C, d 33, 64 and 200, pluck on and off) within
  ``1e-5·max|want|`` of ``linear_ce_loss_ref`` / ``fused_lse_ref``
  evaluated in f64; and against the JAX kernels ``linear_ce_loss`` and
  ``fused_lse`` (interpret mode) on two of ``test_torch_linear_ce.py``'s
  cases;
- the backward model's dX and dW on small versions of the five cases of
  ``test_torch_cuda.py::test_linear_ce_kernels_match_plain`` (pluck on and
  off) within ``1e-5·max|grad| + 2e-4·|grad|`` of ``linear_ce_dx_ref`` /
  ``linear_ce_dw_ref`` evaluated in f64 — at these logit scales (|l| up to
  ≈ 190) the f32 plain version's own CPU matmul misses that tolerance
  against f64 on the d = 200 case, while the model's logits are 4× closer
  to f64 than its — and dX exactly 0 on rows with a zero cotangent; and
  against the JAX kernel's VJP (interpret mode) on two of
  ``test_torch_linear_ce.py``'s cases;
- a step splits ``x`` and ``w`` once, in the autograd forward, which
  hands the planes to the forward kernel and keeps them for both gradient
  kernels (the wrappers' internals patched to plain recorders);
- the launch plans (``linear_sce.fwd_plan``, ``linear_sce.bwd_plan``) fit
  a block's shared memory for every d ≤ 256; at d = 64 the forward's eight
  warps share one SM and two backward blocks share one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_ce as jfused
from repro.kernels import linear_sce as jlinear
from repro_torch.kernels import fused_ce, linear_sce, ref


def _bits(*words):
    return torch.from_numpy(np.array(words, dtype=np.uint32).view(np.float32))


def _as_bits(t):
    return t.numpy().view(np.uint32).tolist()


ROUNDING = {  # name: (input bits, cvt.rna.tf32.f32 bits)
    "exact": (0x3F802000, 0x3F802000),
    "below_tie": (0x3F800FFF, 0x3F800000),
    "tie_away_from_zero": (0x3F801000, 0x3F802000),
    "negative_tie_away_from_zero": (0xBF801000, 0xBF802000),
    "above_tie": (0x3F801001, 0x3F802000),
    "carry_into_exponent": (0x3FFFF000, 0x40000000),
    "largest_finite_to_inf": (0x7F7FFFFF, 0x7F800000),
    "subnormal_tie": (0x00001000, 0x00002000),
    "subnormal_below_tie": (0x80000FFF, 0x80000000),
    "subnormal_carry_to_normal": (0x007FF000, 0x00800000),
    "inf": (0x7F800000, 0x7F800000),
    "negative_inf": (0xFF800000, 0xFF800000),
}


@pytest.mark.parametrize("name", sorted(ROUNDING))
def test_tf32_round_on_values_built_bit_by_bit(name):
    given, want = ROUNDING[name]
    assert _as_bits(ref.tf32_round(_bits(given))) == [want]


def test_tf32_round_passes_nan_through():
    got = ref.tf32_round(_bits(0x7FC00000, 0xFFC00001, 0x7F800001))
    assert torch.isnan(got).all()
    assert _as_bits(got) == [0x7FC00000, 0xFFC00001, 0x7F800001]


def test_tf32x3_split_is_exact_below_2_11():
    """Integers of magnitude below 2¹¹ are TF32 values: hi is the value, lo
    is 0, so integer-valued inputs reach the tensor cores unchanged. 2049
    needs 12 bits: hi + lo still carries it exactly."""
    ints = torch.arange(-2047, 2048, dtype=torch.float32)[:, None]
    planes = ref.tf32x3_planes_ref(ints)
    assert torch.equal(planes[:, 0, 0, 0], ints[:, 0])
    assert (planes[:, 0, 1, 0] == 0).all()
    p = ref.tf32x3_planes_ref(torch.tensor([[2049.0]]))
    assert p[0, 0, 0, 0].item() != 2049.0
    assert p[0, 0, 0, 0].item() + p[0, 0, 1, 0].item() == 2049.0


@pytest.mark.parametrize("d", [1, 16, 33, 64, 200])
def test_tf32x3_planes_layout(d):
    a = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (5, d)).astype(np.float32) * 1e3)
    p = ref.tf32x3_planes_ref(a)
    dp = -(-d // 16) * 16
    assert p.shape == (5, dp // 8, 2, 8) and dp == linear_sce.padded_depth(d)
    hi, lo = _hi_lo(p)
    assert (hi[:, d:] == 0).all() and (lo[:, d:] == 0).all()
    low = p.contiguous().view(torch.int32) & 0x1FFF
    assert (low == 0).all()  # both halves are TF32 values
    hi, lo = hi[:, :d], lo[:, :d]
    assert torch.equal(hi, ref.tf32_round(a))
    assert ((a - hi - lo).abs() <= 2.0**-22 * a.abs()).all()


# -- the model of the kernels' arithmetic ----------------------------------
def _hi_lo(planes):
    """(rows, dp / 8, 2, 8) planes → the (rows, dp) hi and lo matrices."""
    rows = planes.shape[0]
    return (planes[:, :, 0].reshape(rows, -1),
            planes[:, :, 1].reshape(rows, -1))


def _split(a):
    hi = ref.tf32_round(a)
    return hi, ref.tf32_round(a - hi)


def _mm3(ah, al, bh, bl):
    """``(M, K)·(K, N)`` as the kernels take it: per k16 step the three
    TF32 products, small ones first (each exact in f32: 11 by 11 bits),
    summed from zero and added to the f32 total."""
    out = torch.zeros(ah.shape[0], bh.shape[1])
    for k in range(0, ah.shape[1], 16):
        s = slice(k, k + 16)
        out += (al[:, s] @ bh[s] + ah[:, s] @ bl[s]) + ah[:, s] @ bh[s]
    return out


def _tf32x3_forward(x, w, targets, cap):
    """``(loss or None, lse)`` in the forward kernel's arithmetic: the
    logits from the planes, capped, an f32 logsumexp per row, and the
    target's logit plucked from the same capped logits (0 for a target
    outside ``[0, C)``)."""
    xh, xl = _hi_lo(ref.tf32x3_planes_ref(x))
    wh, wl = _hi_lo(ref.tf32x3_planes_ref(w))
    s = _mm3(xh, xl, wh.T, wl.T)
    lg = s if cap is None else cap * torch.tanh(s / cap)
    lse = torch.logsumexp(lg, dim=1)
    if targets is None:
        return None, lse
    t = targets.long()
    valid = (t >= 0) & (t < w.shape[0])
    pos = lg.gather(1, t.clamp(0, w.shape[0] - 1)[:, None])[:, 0]
    return lse - torch.where(valid, pos, 0.0), lse


def _tf32x3_backward(x, w, targets, lse, g, cap):
    """``(dX, dW)`` in the kernels' arithmetic: the logits from the
    planes, the cotangent ``(p − onehot)·cap′·g`` in f32, split again, and
    the second products from the planes."""
    d = x.shape[1]
    xh, xl = _hi_lo(ref.tf32x3_planes_ref(x))
    wh, wl = _hi_lo(ref.tf32x3_planes_ref(w))
    s = _mm3(xh, xl, wh.T, wl.T)
    lg = s if cap is None else cap * torch.tanh(s / cap)
    p = torch.exp(lg - lse[:, None])
    if targets is not None:
        cols = torch.arange(w.shape[0])[None, :]
        p = p - (cols == targets.long()[:, None]).to(torch.float32)
    if cap is not None:
        p = p * (1.0 - (lg / cap) ** 2)
    gh, gl = _split(p * g[:, None])
    dx = _mm3(gh, gl, wh, wl)[:, :d]
    dw = _mm3(gh.T.contiguous(), gl.T.contiguous(), xh, xl)[:, :d]
    return dx, dw


def _close(got, want, rtol=2e-4):
    assert got.shape == want.shape and torch.isfinite(got).all()
    tol = 1e-5 * want.abs().max().item()
    err = (got - want).abs()
    assert (err <= tol + rtol * want.abs()).all(), err.max().item()


CUDA_CASES = {  # (N, C, d, cap, integer, dup, zero_rows), C cut down
    "ragged": (70, 1_037, 64, None, False, False, False),
    "cap30_dup_zero": (70, 1_037, 64, 30.0, False, True, True),
    "int_d33": (130, 1_000, 33, None, True, False, False),
    "cap30_d200_zero": (64, 600, 200, 30.0, False, False, True),
    "many_tiles_dup_zero": (300, 3_000, 64, None, False, True, True),
}


def _cuda_problem(name):
    """The CUDA test's inputs at this size, from numpy: x at 3·randn (the
    trainer's logit scale), w at randn, or integers in [−2, 2]."""
    n, c, d, cap, integer, dup, zero_rows = CUDA_CASES[name]
    rng = np.random.default_rng(n + c + d)
    if integer:
        x = rng.integers(-2, 3, (n, d)).astype(np.float32)
        w = rng.integers(-2, 3, (c, d)).astype(np.float32)
    else:
        x = (3.0 * rng.standard_normal((n, d))).astype(np.float32)
        w = rng.standard_normal((c, d)).astype(np.float32)
    t = rng.integers(0, c, n).astype(np.int32)
    if dup:
        t[: n // 2] = c - 1
    g = (rng.random(n) + 0.5).astype(np.float32)
    if zero_rows:
        g[::3] = 0.0
    return (*map(torch.from_numpy, (x, w, t, g)), cap)


@pytest.mark.parametrize("pluck", [True, False])
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_tf32x3_forward_holds_the_chip_tolerance(name, pluck):
    """Without pluck the fused family: no cap (it takes none), the lse
    alone."""
    x, w, t, _, cap = _cuda_problem(name)
    if not pluck:
        t, cap = None, None
    loss, lse = _tf32x3_forward(x, w, t, cap)
    xd, wd = x.double(), w.double()
    want_lse = ref.fused_lse_ref(xd, wd, logit_softcap=cap)
    assert want_lse.dtype == torch.float64
    _close(lse, want_lse.float(), rtol=0.0)
    if pluck:
        want = ref.linear_ce_loss_ref(xd, wd, t, logit_softcap=cap)
        _close(loss, want.float(), rtol=0.0)


@pytest.mark.parametrize("pluck", [True, False])
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_tf32x3_backward_holds_the_chip_tolerance(name, pluck):
    x, w, t, g, cap = _cuda_problem(name)
    if not pluck:
        t, cap = None, None
    lse = ref.fused_lse_ref(x, w, logit_softcap=cap)
    dx, dw = _tf32x3_backward(x, w, t, lse, g, cap)
    exact = (x.double(), w.double(), t, lse.double(), g.double())
    want_dx = ref.linear_ce_dx_ref(*exact, logit_softcap=cap)
    want_dw = ref.linear_ce_dw_ref(*exact, logit_softcap=cap)
    assert want_dx.dtype == want_dw.dtype == torch.float64
    _close(dx, want_dx.float())
    _close(dw, want_dw.float())
    assert (dx[g == 0] == 0).all()


JAX_CASES = {  # test_torch_linear_ce.py's cases: (N, C, d, cap, x scale)
    "ragged_c": (40, 300, 16, None, 1.0),
    "cap30": (40, 300, 16, 30.0, 4.0),
}


@pytest.mark.parametrize("family", ["linear", "fused"])
@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_tf32x3_forward_matches_the_jax_kernel(name, family):
    """``linear``: the loss against ``linear_ce_loss``; ``fused``: the lse
    against ``fused_lse`` (no cap: it takes none)."""
    n, c, d, cap, scale = JAX_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = (scale * rng.standard_normal((n, d))).astype(np.float32)
    w = rng.standard_normal((c, d)).astype(np.float32)
    t = rng.integers(0, c, n).astype(np.int32)
    xt, wt, tt = map(torch.from_numpy, (x, w, t))
    if family == "linear":
        want = jlinear.linear_ce_loss(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(t), cap, 16, 64, True)
        got = _tf32x3_forward(xt, wt, tt, cap)[0]
    else:
        want = jfused.fused_lse(jnp.asarray(x), jnp.asarray(w), 16, 64, True)
        got = _tf32x3_forward(xt, wt, None, None)[1]
    _close(got, torch.from_numpy(np.array(want)), rtol=0.0)


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_tf32x3_backward_matches_the_jax_kernel(name):
    n, c, d, cap, scale = JAX_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = (scale * rng.standard_normal((n, d))).astype(np.float32)
    w = rng.standard_normal((c, d)).astype(np.float32)
    t = rng.integers(0, c, n).astype(np.int32)
    g = rng.uniform(0.5, 1.5, n).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, b: jlinear.linear_ce_loss(a, b, jnp.asarray(t), cap, 16,
                                            64, True),
        jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (torch.from_numpy(np.array(a))
                        for a in vjp(jnp.asarray(g)))
    xt, wt, tt, gt = map(torch.from_numpy, (x, w, t, g))
    lse = ref.fused_lse_ref(xt, wt, logit_softcap=cap)
    dx, dw = _tf32x3_backward(xt, wt, tt, lse, gt, cap)
    _close(dx, want_dx)
    _close(dw, want_dw)


# -- a step shares one split -------------------------------------------------
def _recorders(monkeypatch):
    """Patch the wrappers' launches to the plain versions and record the
    planes that forward and backward hand them."""
    seen = {"split": [], "fwd": [], "dx": [], "dw": []}

    def fwd(x, w, targets, cap, planes=None):
        seen["fwd"].append(planes)
        lse = ref.fused_lse_ref(x, w, logit_softcap=cap)
        loss = (None if targets is None else
                ref.linear_ce_loss_ref(x, w, targets, logit_softcap=cap))
        return loss, lse

    def split(x, w):
        planes = (ref.tf32x3_planes_ref(x), ref.tf32x3_planes_ref(w))
        seen["split"].append(planes)
        return planes

    def grad(kind, plain):
        def run(x, w, targets, lse, g, cap, planes=None):
            seen[kind].append(planes)
            return plain(x, w, targets, lse, g, logit_softcap=cap)
        return run

    monkeypatch.setattr(linear_sce, "_fwd", fwd)
    monkeypatch.setattr(linear_sce, "_split", split)
    monkeypatch.setattr(linear_sce, "_dx", grad("dx", ref.linear_ce_dx_ref))
    monkeypatch.setattr(linear_sce, "_dw", grad("dw", ref.linear_ce_dw_ref))
    return seen


@pytest.mark.parametrize("family", ["linear", "fused"])
def test_backward_splits_once_and_shares_the_planes(family, monkeypatch):
    """One split per step, in the forward: the forward kernel, dX and dW
    all take its planes."""
    seen = _recorders(monkeypatch)
    x, w, t, g, _ = _cuda_problem("ragged")
    xx, ww = (a.clone().requires_grad_(True) for a in (x, w))
    before = linear_sce.linear_ce_split.launches
    if family == "linear":
        out = linear_sce.linear_ce_loss(xx, ww, t)
        targets = t
    else:
        out = fused_ce.fused_lse(xx, ww)
        targets = None
    assert linear_sce.linear_ce_split.launches - before == 1
    got = torch.autograd.grad((out * g).sum(), (xx, ww))
    assert linear_sce.linear_ce_split.launches - before == 1
    assert len(seen["split"]) == len(seen["fwd"]) == 1
    for kernel in ("fwd", "dx", "dw"):
        planes = seen[kernel][0]
        assert len(seen[kernel]) == 1 and len(planes) == 2
        assert all(p is q for p, q in zip(planes, seen["split"][0]))
    lse = ref.fused_lse_ref(x, w)
    want = (ref.linear_ce_dx_ref(x, w, targets, lse, g),
            ref.linear_ce_dw_ref(x, w, targets, lse, g))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_launch_plan_fits_the_card():
    for d in range(1, linear_sce.MAX_D + 1):
        assert linear_sce.padded_depth(d) % 16 == 0
        assert linear_sce.planned_smem(d) <= linear_sce.MAX_SMEM
        for dw in (False, True):
            warps, stages, smem = linear_sce.bwd_plan(d, dw)
            assert warps in (1, 2, 4) and stages in (2, 3)
            assert smem <= linear_sce.MAX_SMEM
        warps, stages, smem = linear_sce.fwd_plan(d)
        assert 1 <= warps <= 8 and stages in (2, 3)
        assert smem <= linear_sce.MAX_SMEM
        assert linear_sce.planned_smem(d) >= smem
        dp, rows = linear_sce.padded_depth(d), linear_sce.fwd_rows(d)
        assert smem == 8 * dp * (32 * warps + rows * stages)
    # d = 64: two blocks of four warps share an SM (228 KB, 1 KB a block)
    assert linear_sce.bwd_plan(64, False) == (4, 3, 114_688)
    assert linear_sce.bwd_plan(64, True) == (4, 2, 99_072)
    assert 2 * (114_688 + 1024) <= 233_472
    # the forward: eight warps own 256 positions beside three 64-row stages
    assert linear_sce.fwd_plan(64) == (8, 3, 229_376)
    assert linear_sce.fwd_rows(64) == 64 and linear_sce.fwd_rows(65) == 32
    assert linear_sce.fwd_plan(256) == (1, 2, 196_608)
