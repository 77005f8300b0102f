"""The bf16 product of ``csrc/deep_tc.cuh`` (``gemm_bf16``) and the deep
SCE and full-CE backwards built on it, on the CPU.

On bfloat16 operands the deep SCE entries (the logits, dX = G · Y[idx],
dY's slot rows Gᵀ · x_b) and the deep ``linear_ce`` entries (the chunk's
logits, dX += G · W_chunk, dW_chunk = Gᵀ · X) run ``wgmma`` m64n128k16
.f32.bf16.bf16: both operands read as stored, every product exact, the
sum accumulated in f32 in the tensor cores over k16 steps in ascending
depth; the cotangent G is written as bf16 (the f32 cotangent rounded
once, the reference's ``gw.astype(tile.dtype)``); a bf16 catalog's dY
sum is written as bf16 (each row's f32 sum rounded once). A CUDA kernel
has no CPU mode, so here:

- a plain model of the bf16 product (operands rounded to bf16 and
  widened, each k16 step's exact products summed and added to the f32
  total, one rounding a step) within ``1e-5·max|C| + 2e-4·|C|`` of f64 —
  the f32 deep product's tolerance — and of ``ref.deep_tc_ref`` in every
  orientation (A M-major, B N-major), with B gathered by clamped id, the
  accumulate epilogue and zeroed rows;
- the kernels' rounding of the cotangent (``round_bf16`` of
  ``tf32x3_tile.cuh``, modelled bit for bit) equal to ``.to(bfloat16)``
  of the f32 cotangent, for the deep SCE and the deep full CE, ties,
  infinities and NaN included;
- ``sce_prefetch.dy_sum_plain`` into a bf16 table equal to the f32 sum in
  ascending slot order rounded once;
- the deep SCE (loss and partial LSE) and the deep ``linear_ce`` /
  ``fused_lse`` on bf16 inputs at d 288 and 300, in the deep variants'
  arithmetic on that product (``tests/test_torch_deep_tc.py``'s models
  with the bf16 product in), against the JAX kernels in interpret mode
  at ``tests/test_torch_bf16.py``'s tolerance (3e-2 of each tensor's
  largest magnitude).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_bf16 as tb
import test_torch_deep_tc as dt
from repro.kernels import fused_ce as jfused
from repro.kernels import linear_sce as jlinear
from repro.kernels import ops as jops
from repro_torch.kernels import linear_sce, ref, sce_prefetch

BF = torch.bfloat16


def _bf16_product(a, b):
    """``a (…, M, K) · b (…, N, K)ᵀ`` as ``gemm_bf16`` takes it: both
    rounded to bf16 (the cotangent too) and widened, each k16 step's
    exact products summed (f64 holds each exactly) and added to the f32
    total in ascending depth."""
    a = a.to(BF).double()
    b = b.to(BF).double().transpose(-1, -2)
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k in range(0, a.shape[-1], 16):
        s = slice(k, k + 16)
        out = (out.double() + a[..., s] @ b[..., s, :]).float()
    return out


def _model(a, b, *, a_km=False, b_kn=False, idx=None, out=None,
           m_zero=None):
    """``_bf16_product`` with ``deep_tc_product``'s operand options."""
    a_ = a.transpose(1, 2) if a_km else a
    if idx is not None:
        rows = b[idx.long().clamp(0, b.shape[0] - 1)]
        b_ = rows.transpose(1, 2) if b_kn else rows
    else:
        b_ = b.transpose(1, 2) if b_kn else b
    c = _bf16_product(a_, b_)
    if m_zero is not None:
        c = torch.where((m_zero < 0)[..., None], 0.0, c)
    return c if out is None else out + c


@pytest.mark.parametrize("m,n,k", [(37, 29, 300), (5, 7, 37),
                                   (20, 24, 2304)])
@pytest.mark.parametrize("a_km,b_kn,gather,acc",
                         list(itertools.product((False, True), repeat=4)))
def test_bf16_product_model_holds_f64(m, n, k, a_km, b_kn, gather, acc):
    rng = np.random.default_rng(m + n + k + 8 * a_km + 4 * b_kn + 2 * gather
                                + acc)
    t = 2

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(BF)

    a = bf(t, k, m) if a_km else bf(t, m, k)
    idx = None
    if gather:
        b = bf(50, n) if b_kn else bf(50, k)
        idx = torch.from_numpy(rng.integers(-2, 52, (t, k if b_kn else n))
                               .astype(np.int32))
    else:
        b = bf(t, k, n) if b_kn else bf(t, n, k)
    m_zero = (torch.from_numpy(rng.integers(-1, 3, (t, m)).astype(np.int32))
              if a_km else None)
    out0 = (torch.from_numpy(rng.standard_normal((t, m, n))
                             .astype(np.float32)) if acc else None)
    kw = dict(a_km=a_km, b_kn=b_kn, idx=idx, m_zero=m_zero)
    got = _model(a, b, out=out0, **kw)
    want = ref.deep_tc_ref(a.double(), b.double(),
                           out=None if out0 is None else out0.double(), **kw)
    dt._close(got, want)
    dt._close(got, ref.deep_tc_ref(a, b, out=out0, **kw))
    if m_zero is not None:
        assert (got[m_zero < 0] == (out0[m_zero < 0] if acc else 0)).all()


def _round_bf16(v):
    """``tf32x3::round_bf16`` as the cotangent kernels and the dY sum
    write a bf16 value (``bits = round_bf16(v) >> 16``): round to nearest
    even on the f32 bits, a NaN made quiet; → the bf16 tensor."""
    u = v.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    r = torch.where(nan, u | 0x400000, u + 0x7FFF + ((u >> 16) & 1))
    bits = ((r >> 16) & 0xFFFF).to(torch.int32)
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return bits.to(torch.int16).view(BF)


def _same_bf16(got, want):
    """Equal bits, NaN equal to NaN."""
    g, w = got.view(torch.int16), want.view(torch.int16)
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(g[~nan], w[~nan])


def test_cotangent_rounding_edges():
    """Ties to even both ways, the largest values that round to inf, the
    smallest subnormals, signed zeros, inf and NaN."""
    bits = torch.tensor([0x3F808000, 0x3F818000, 0x3F80C000, 0x7F7FFFFF,
                         0x7F7F8000, 0x00000001, 0x00008000, 0x80000000,
                         0x7F800000, 0xFF800000, 0x7FC00001, 0x00018000,
                         0xBF808001], dtype=torch.int64)
    v = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32) \
        .view(torch.float32)
    _same_bf16(_round_bf16(v), v.to(BF))


@pytest.mark.parametrize("cap", [None, 30.0])
def test_bf16_cotangents_are_the_f32_cotangents_rounded(cap):
    """The deep backwards' bf16 cotangent buffers (SCE: 0 where masked,
    else exp(min(l − lse, 44))·cap′·g; full CE: (p − onehot)·cap′·g) hold
    ``round_bf16`` of the f32 cotangent, which is ``.to(bfloat16)`` bit for
    bit — the rounding the reference's ``gw.astype(tile.dtype)`` and
    ``ref``'s plain versions apply."""
    x_b, y, idx, tgt, cand, pos, g = (
        torch.from_numpy(a) for a in dt._sce_problem(2, 20, 40, 288, 90,
                                                     False))
    x_b, y = x_b.to(BF).float(), y.to(BF).float()
    lg = _bf16_product(x_b, y[idx.long()])
    if cap is not None:
        lg = cap * torch.tanh(lg / cap)
    masked = (cand[:, None, :] < 0) | (cand[:, None, :] == tgt[:, :, None])
    lse = torch.logsumexp(torch.where(masked, dt.NEG_INF, lg), -1)
    p = torch.exp(torch.clamp(lg - lse[..., None], max=dt.MAX_EXP))
    if cap is not None:
        p = p * (1.0 - (lg / cap) ** 2)
    gw = torch.where(masked, 0.0, p * g[..., None])
    _same_bf16(_round_bf16(gw), gw.to(BF))
    x, w, t, gc = (torch.from_numpy(a)
                   for a in dt._ce_problem(37, 1_000, 288, 256))
    lg = _bf16_product(x, w)
    if cap is not None:
        lg = cap * torch.tanh(lg / cap)
    lse = torch.logsumexp(lg, -1)
    p = torch.exp(lg - lse[:, None])
    hit = torch.arange(w.shape[0])[None, :] == t.long()[:, None]
    p = p - hit.float()
    if cap is not None:
        p = p * (1.0 - (lg / cap) ** 2)
    gw = p * gc[:, None]
    assert (gw.to(BF).float() != gw).any()  # the rounding acts
    _same_bf16(_round_bf16(gw), gw.to(BF))


def test_dy_sum_plain_into_bf16_is_the_f32_sum_rounded_once():
    """``dy_sum_plain`` with ``dtype=bf16`` (a bf16 catalog's gradient):
    every selected row the f32 sum of its slots' rows in ascending slot
    order, rounded once; rows no slot selected exactly 0; the ids' and
    the negative ids' slots as the kernel's keys treat them."""
    rng = np.random.default_rng(4)
    n_b, b_y, d, c = 3, 40, 36, 50
    ws = torch.from_numpy(rng.standard_normal((n_b * b_y, d))
                          .astype(np.float32))
    idx = torch.from_numpy(rng.integers(-3, c + 3, (n_b, b_y))
                           .astype(np.int32))
    cand = idx.clone()
    cand[:, ::7] = -1
    got = sce_prefetch.dy_sum_plain(ws, idx, cand, c, BF)
    assert got.dtype == BF
    want = torch.zeros(c, d)
    for slot, (r, keep) in enumerate(zip(idx.reshape(-1).tolist(),
                                         cand.reshape(-1).tolist())):
        if keep >= 0:
            want[min(max(r, 0), c - 1)] += ws[slot]
    assert torch.equal(got, want.to(BF))
    assert torch.equal(got, sce_prefetch.dy_sum_plain(ws, idx, cand, c)
                       .to(BF))
    hit = torch.zeros(c, dtype=torch.bool)
    hit[idx.reshape(-1)[cand.reshape(-1) >= 0].long().clamp(0, c - 1)] = True
    assert (got[~hit].float() == 0).all()


# -- the deep SCE and full CE on the bf16 product ------------------------------
@pytest.mark.parametrize("d", [288, 300])
@pytest.mark.parametrize("plse,cap", [(True, 30.0), (False, None)])
def test_deep_bf16_sce_matches_the_jax_kernel(monkeypatch, d, plse, cap):
    """The deep SCE's arithmetic with the bf16 product (the logits, the
    fold, the cotangent rounded to bf16 by the product model, dX and dY's
    slot rows, dY summed in f32 and rounded once) on bf16 x_b and y,
    against ``sce_gather_plse`` / ``sce_gather_loss`` (interpret mode) on
    the same bf16 inputs: values and VJPs within 3e-2 of their scale."""
    monkeypatch.setattr(dt, "_product", _bf16_product)
    (x_b, jx), (y, jy), idx, tgt, cand, (pos, jpos), g = tb._sce_problem(
        d + plse, 2, 20, 40, d, 90)
    kw = dict(block_bx=16, block_by=16, interpret=True, logit_softcap=cap)

    def f(a, b, p):
        if plse:
            return jops.sce_gather_plse(a, b, idx, tgt, cand, **kw)
        return jops.sce_gather_loss(a, b, idx, tgt, cand, p, **kw)

    want, (wdx, wdy, _) = tb._jax_grads(f, (jx, jy, jpos), g)
    t = [torch.from_numpy(a) for a in (idx, tgt, cand, g)]
    out, dx, dy = dt._sce_model(x_b.float(), y.float(), t[0], t[1], t[2],
                                None if plse else pos.float(), t[3], cap)
    tb._close(out, want)
    tb._close(dx.to(BF), wdx)
    tb._close(dy.to(BF), wdy)


@pytest.mark.parametrize("n,c,d,chunk", [(37, 1_000, 288, 256),
                                         (21, 700, 300, 128)])
@pytest.mark.parametrize("family,cap", [("linear", None), ("linear", 30.0),
                                        ("fused_lse", None)])
def test_deep_bf16_full_ce_matches_the_jax_kernel(monkeypatch, n, c, d, chunk,
                                                  family, cap):
    """The deep full CE's arithmetic with the bf16 product (chunk logits,
    the fold in chunk order, the cotangent rounded to bf16 by the product
    model, dX accumulated over the chunks, dW's rows) on bf16 x and w,
    against ``linear_ce_loss`` / ``fused_lse`` (interpret mode) on the
    same bf16 inputs: values and VJPs within 3e-2 of their scale."""
    monkeypatch.setattr(dt, "_product", _bf16_product)
    (x, jx), (w, jw), t, g = tb._ce_problem(n + c + d, n, c, d)
    if family == "linear":
        f = lambda a, b: jlinear.linear_ce_loss(  # noqa: E731
            a, b, jnp.asarray(t), cap, 16, 128, True)
        targets = torch.from_numpy(t)
    else:
        f = lambda a, b: jfused.fused_lse(a, b, 16, 128, True)  # noqa: E731
        targets = None
    want, (wdx, wdw) = tb._jax_grads(f, (jx, jw), g)
    xt, wt, gt = x.float(), w.float(), torch.from_numpy(g)
    loss, lse = dt._ce_forward(xt, wt, targets, cap, chunk)
    dx, dw = dt._ce_backward(xt, wt, targets, lse, gt, cap, chunk)
    tb._close(lse if targets is None else loss, want)
    tb._close(dx.to(BF), wdx)
    tb._close(dw.to(BF), wdw)


def test_bf16_deep_chunk_holds_logits_and_cotangent_in_the_budget():
    """On bf16 operands a chunk's f32 logits and its bf16 cotangent (6
    bytes an entry) share the slab budget; f32 keeps its chunk."""
    from repro_torch.kernels import deep

    for n, c in ((4_096, 256_000), (37, 1_000), (100_000, 256_000)):
        f32 = linear_sce.deep_chunk(n, c)
        bf = linear_sce.deep_chunk(n, c, BF)
        assert bf <= f32 and bf % 4 == 0
        assert 6 * n * bf <= deep.SLAB_BYTES or bf == 4
        assert bf == -(-c // 4) * 4 or bf % deep.SLAB_ALIGN == 0
    assert linear_sce.deep_chunk(4_096, 256_000) == 65_536
    assert linear_sce.deep_chunk(4_096, 256_000, BF) == 43_648
