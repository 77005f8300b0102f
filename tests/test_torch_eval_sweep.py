"""The deep eval sweep that reads the score slab (``csrc/topk_tile.cuh``
``FROM_S``, behind ``eval_fused``, ``eval_topk`` and the deep
``mips_topk`` at k ≤ 32), on the CPU.

Above d 256 the sweep reads a ``(C, n)`` f32 score slab, row pitch
``slab_ld(n)``, through a ring of ``SLAB_STAGES`` shared-memory stages
that TMA boxes fill (64 catalog rows × the block's query columns a
box, 32 columns in the 128-byte swizzle), at its own plan (``mips_topk.slab_sweep_plan``: blocks of 1 or 4
query tiles, up to 4 an SM). A CUDA kernel has no CPU mode, so here, at
d 288 and 300 and catalogs of a few thousand rows:

- the plan: the ring, lists and buffers of every launch fit ``MAX_SMEM``
  at every deep shape ``test_torch_deep.py`` covers, the grid is one
  wave, the splits cover every catalog tile once (the pre-pass's sample
  once too), the slab and its boxes fit a tensor map's rules and the
  swizzled fragment reads take at most two wavefronts a half-warp;
- a plain model of the plan's fold (each thread's tiles in order, its
  rows a tile in order, the 8 lanes of a query in the shuffle tree, the
  warps, then the splits), from a given slab: its ids and counts equal
  ``ref.eval_fused_ref`` on the same slab exactly (x the identity, y the
  slab: the plain version's scores are the slab's bits), windows, ragged
  C and n, ties and targets outside the window included; its LSE lies
  within ``1e-5`` relative of f64 and of the JAX ``eval_fused``
  (interpret mode) on the bf16 and f32 inputs whose slab it is, cap 30.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_bf16 as tb
import test_torch_bf16_tc as btc
from repro.kernels import eval_fused as jeval
from repro.kernels import guard as jguard
from repro_torch.kernels import mips_topk as kernel
from repro_torch.kernels import ref

BF = torch.bfloat16
NEG_INF = -1e30
CAP = 30.0
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
DEEP_SHAPES = [(128, 256_000), (8_192, 256_000), (8, 4_096)]
WM, MT = 4, 1  # Cfg<1> and Cfg<4>: warps across a tile's rows, m16 tiles


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests' many small tensor operations,
    run beside other test processes, would otherwise spin for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_q,c", DEEP_SHAPES)
@pytest.mark.parametrize("k", [1, 10, 32, 128, 512])
def test_slab_plan_fits_shared_memory_in_one_wave(n_q, c, k):
    """Every launch of the deep sweep fits 227 KB (the ring, lists and
    buffers; the pre-pass's τ selection; the merge) at its slab's rows;
    its blocks fill at most one wave of the blocks an SM holds."""
    rows = kernel.slab_rows(n_q, c)
    for d in (257, 288, 300, 2_304, 8_192):
        assert kernel.sweep_smem(n_q, c, d, k, 132) <= kernel.MAX_SMEM
        assert kernel.sweep_plan(rows, c, d, k, 132) == \
            kernel.slab_sweep_plan(rows, c, k, 132)
    p = kernel.slab_sweep_plan(rows, c, k, 132)
    assert p.query_tiles in kernel.SLAB_QUERY_TILES
    smem = kernel.sweep_smem_bytes(p.query_tiles, 300, k)
    per_sm = min(kernel.SLAB_MIN_BLOCKS, kernel.SM_SMEM // (smem + 1024))
    n_qb = -(-rows // (8 * p.query_tiles))
    assert per_sm >= 1
    assert n_qb * p.n_split <= max(per_sm * 132, n_qb)
    if k <= kernel.SMALL_K and -(-c // kernel.TILE_C) >= 128:
        assert p.pre_split > 0 and p.pre_period == 8 * p.pre_split


def test_slab_plan_of_the_token_rank():
    """gemma-2-2b's token rank (slabs of 1,024 rows against 256,000
    tokens, k 1): blocks of 32 query columns, 4 an SM, 16 splits (512
    blocks on 528 places), a pre-pass of 16 splits over one tile in 8."""
    assert kernel.slab_rows(8_192, 256_000) == 1_024
    assert kernel.slab_sweep_plan(1_024, 256_000, 1, 132) == \
        kernel.SweepPlan(4, 16, 16, 128)
    assert kernel.sweep_smem_bytes(4, 2_304, 1) * 4 + 4 * 1024 <= \
        kernel.SM_SMEM


@pytest.mark.parametrize("c", [1, 63, 64, 1_000, 3_001, 256_000])
@pytest.mark.parametrize("n_split", [1, 3, 16, 17])
def test_slab_splits_cover_every_tile_once(c, n_split):
    """The splits' tiles ``[⌊s·T/S⌋, ⌊(s+1)·T/S⌋)`` and the pre-pass's
    strided sample (tiles ``s, s + period, …``) each visit a tile at most
    once; the splits visit every tile."""
    tiles = -(-c // kernel.TILE_C)
    n_split = min(n_split, tiles)
    seen = np.zeros(tiles, dtype=int)
    for s in range(n_split):
        lo, hi = kernel.split_bounds(c, n_split, s)
        seen[lo // kernel.TILE_C:-(-hi // kernel.TILE_C)] += 1
    assert (seen == 1).all()
    period = 8 * n_split
    sample = np.zeros(tiles, dtype=int)
    for s in range(n_split):
        sample[s:tiles:period] += 1
    want = (np.arange(tiles) % period) < n_split
    assert np.array_equal(sample, want.astype(int))


def _stage_at(qb, r, col):
    """``stage_at`` in the source: a stage's float index of (row, column),
    32 columns in the TMA's 128-byte swizzle (the 16-byte chunk c of row
    r at c ^ (r & 7)), 8 as they are."""
    if qb == 32:
        return r * qb + (((col >> 2) ^ (r & 7)) << 2) + (col & 3)
    return r * qb + col


@pytest.mark.parametrize("query_tiles", kernel.SLAB_QUERY_TILES)
@pytest.mark.parametrize("n_q", [1, 5, 8, 37, 130, 1_024])
def test_ring_boxes_fit_the_tensor_map_and_reads_spread(query_tiles, n_q):
    """The slab's rows are 16-byte multiples (a tensor map's rule), a
    box row too, a stage a whole number of 1 KB (the swizzle's unit);
    the stage's layout is a permutation of each row's columns; a
    half-warp's LDS.64 fragment reads (rows 16·wm + gq + 8·h for gq
    0..3, columns 8·nt + 2q, 2q + 1) take at most two wavefronts (a bank
    holds at most two of its distinct words)."""
    qb = 8 * query_tiles
    ld = kernel.slab_ld(n_q)
    assert ld % 4 == 0 and ld >= n_q and ld - n_q < 4
    assert (4 * qb) % 16 == 0 and qb <= 256
    assert (4 * kernel.TILE_C * qb) % 1024 == 0
    for r in range(kernel.TILE_C):
        at = sorted(_stage_at(qb, r, col) for col in range(qb))
        assert at == list(range(r * qb, (r + 1) * qb))
    for wm in range(WM):
        for h in range(2):
            for nt in range(qb // 8):
                words = {}
                for gq in range(4):
                    for q in range(4):
                        at = _stage_at(qb, 16 * wm + gq + 8 * h,
                                       8 * nt + 2 * q)
                        assert at % 2 == 0  # an aligned float2
                        for w in (at, at + 1):
                            words.setdefault(w % 32, set()).add(w)
                assert max(len(v) for v in words.values()) <= \
                    (2 if qb == 32 else 1)


# ---------------------------------------------------------------------------
# The fold's model
# ---------------------------------------------------------------------------
def _combine(m, s, m2, s2):
    """``lse_combine`` in f32: (m, s) of two disjoint column sets."""
    mn = torch.maximum(m, m2)
    return mn, s * torch.exp(m - mn) + s2 * torch.exp(m2 - mn)


def _select(v, i, k):
    """Top-``k`` of ``(v, i)`` along dim 1 under the merge key (value
    descending, lower id first); ``(NEG_INF, ID_PAD)`` past the valid."""
    order = torch.argsort(i, dim=1, stable=True)
    v, i = torch.gather(v, 1, order), torch.gather(i, 1, order)
    order = torch.argsort(v, dim=1, descending=True, stable=True)[:, :k]
    v, i = torch.gather(v, 1, order), torch.gather(i, 1, order)
    pad = torch.full((v.shape[0], max(0, k - v.shape[1])), NEG_INF)
    v = torch.cat([v, pad], 1)
    i = torch.cat([i, torch.full(pad.shape, ref.ID_PAD, dtype=i.dtype)], 1)
    return v, torch.where(v == NEG_INF, ref.ID_PAD, i).to(torch.int32)


def _sweep_model(s_slab, targets, tgt, k, c_lo, c_hi, cap, plan):
    """The deep eval sweep on the slab ``s_slab (C, n)`` at ``plan``: the
    top-k under (value descending, lower id first) and gt / eq with the
    self-column rule over the valid columns; per split, each thread (warp
    wm, lane row gq) folds its rows ``16·wm + gq + 8·h`` of each of the
    split's tiles in order into an online (m, s) in base-2 units — the
    capped logit as ``cap·log2(e)·(1 − 2 / (1 + 2^(2·log2(e)·x / cap)))``,
    the tile's max, then its exp2s in row order; m back to natural units
    at the end —; the 8 lanes of a query combine in the shuffle tree
    (lane ^ 1, ^ 2, ^ 4), the warps in order, then the splits in order.
    Returns ``(vals, ids, gt, eq, m, s)``."""
    c, n = s_slab.shape
    gid = torch.arange(c)
    valid = (gid >= c_lo) & (gid < c_hi)
    sv = torch.where(valid[:, None], s_slab, torch.tensor(NEG_INF))
    self_ = gid[:, None] == targets[None, :].long()
    log2e = torch.tensor(LOG2E)
    if cap:
        kv = torch.tensor(cap) * log2e
        lv = kv - 2 * kv / (1 + torch.exp2(s_slab * (2 * log2e / cap)))
    else:
        lv = s_slab * log2e
    # each thread's rows of tile t: 64·t + 16·wm + gq + 8·h (MT = 1); a
    # row past C reads row C (kNegInf), masked as the window's are
    lvp = torch.cat([lv, torch.full((1, n), NEG_INF)])
    okp = torch.cat([valid, torch.tensor([False])])
    thread_rows = (16 * torch.arange(WM)[:, None, None]
                   + torch.arange(8)[None, :, None]
                   + 8 * torch.arange(2)[None, None, :])  # (WM, 8, 2)
    # the counts and the lists do not depend on how the splits cut the
    # columns (integer sums; a total order): one pass over the slab
    gt = ((sv > tgt) & ~self_).sum(0).to(torch.int32)
    eq = ((sv == tgt) | (self_ & valid[:, None])).sum(0).to(torch.int32)
    vals, ids = _select(sv.T, gid.expand(n, -1).to(torch.int32), k)
    m_all = torch.full((n,), NEG_INF)
    s_all = torch.zeros(n)
    for sp in range(plan.n_split):
        lo, hi = kernel.split_bounds(c, plan.n_split, sp)
        m = torch.full((WM, 8, n), NEG_INF)  # every thread's (m, s)
        s = torch.zeros(WM, 8, n)
        for t in range(lo // kernel.TILE_C, -(-hi // kernel.TILE_C)):
            r = (kernel.TILE_C * t + thread_rows).clamp(max=c)
            ok = okp[r][..., None]                          # (WM, 8, 2, 1)
            tile = torch.where(ok, lvp[r], torch.tensor(NEG_INF))
            mn = torch.maximum(m, tile.amax(2))
            e = torch.where(ok, torch.exp2(tile - mn[:, :, None]), 0.0)
            s = s * torch.exp2(m - mn) + (e[:, :, 0] + e[:, :, 1])
            m = mn
        m = torch.where(m == NEG_INF, m, m * LN2)
        for step in (1, 2, 4):  # the lanes' shuffle tree
            partner = torch.arange(8) ^ step
            m, s = _combine(m, s, m[:, partner], s[:, partner])
        mw, sw = torch.full((n,), NEG_INF), torch.zeros(n)
        for w in range(WM):  # the warps in order
            mw, sw = _combine(mw, sw, m[w, 0], s[w, 0])
        m_all, s_all = _combine(m_all, s_all, mw, sw)
    return vals, ids, gt, eq, m_all, s_all


def _slab_problem(seed, n, c, d, kind):
    """A slab ``(C, n)`` and the inputs it is the product of (``x (n, d)``,
    ``y (C, d)``): ``bf16`` the card's bf16 product of bf16 inputs,
    ``f32`` the f32 product of f32 inputs, ``ties`` integer scores in
    [-3, 3] (a slab only)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        s = torch.from_numpy(rng.integers(-3, 4, (c, n)).astype(np.float32))
        return rng, s, None
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    y = torch.from_numpy(
        0.5 * rng.standard_normal((c, d)).astype(np.float32))
    if kind == "bf16":
        x, y = x.to(BF), y.to(BF)
        return rng, btc._bf16_product(y, x), (x, y)
    return rng, y @ x.T, (x, y)


def _jax(a):
    """The JAX array of a torch tensor's values, in its type."""
    j = jnp.asarray(a.float().numpy())
    return j.astype(jnp.bfloat16) if a.dtype == BF else j


def _on_slab(s_slab, d):
    """Inputs of ``ref.eval_fused_ref`` whose scores are the slab's bits:
    x the identity (n, d) and y the slab (C, d), zeros past n."""
    c, n = s_slab.shape
    x = torch.zeros(n, d)
    x[torch.arange(n), torch.arange(n)] = 1.0
    y = torch.zeros(c, d)
    y[:, :n] = s_slab
    return x, y


@pytest.mark.parametrize("d", [288, 300])
@pytest.mark.parametrize("kind", ["bf16", "f32", "ties"])
@pytest.mark.parametrize("n,c,k,c_lo,c_hi,n_sm", [
    (37, 1_000, 1, 1, 1_000, 132),    # C not a multiple of 64, LM window
    (130, 3_001, 10, 70, 2_990, 132),  # a window that cuts tiles
    (5, 50, 32, 0, 50, 132),           # C below one tile, k above it
    (130, 3_001, 1, 1, 3_001, 2),      # several tiles a split
])
def test_model_ids_and_counts_equal_the_plain_version_on_the_slab(
        d, kind, n, c, k, c_lo, c_hi, n_sm):
    rng, s_slab, _ = _slab_problem(n + c + d, n, c, d, kind)
    t = rng.integers(max(0, c_lo - 3), min(c, c_hi + 3), n).astype(np.int32)
    tt = torch.from_numpy(t)
    tgt = s_slab[tt.long(), torch.arange(n)]
    plan = kernel.slab_sweep_plan(n, c, k, n_sm)
    got = _sweep_model(s_slab, tt, tgt, min(k, c), c_lo, c_hi, CAP, plan)
    x, y = _on_slab(s_slab, d)
    want = ref.eval_fused_ref(x, y, tt, min(k, c), tgt_scores=tgt,
                              c_lo=c_lo, c_hi=c_hi, logit_softcap=CAP,
                              with_lse=True)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    inside = (tt >= c_lo) & (tt < c_hi)
    assert (got[3][inside] >= 1).all()
    lse = (got[4] + torch.log(got[5])).double()
    lv = CAP * torch.tanh(s_slab.double() / CAP)
    win = (torch.arange(c) >= c_lo) & (torch.arange(c) < c_hi)
    want64 = torch.logsumexp(torch.where(win[:, None], lv, -np.inf), 0)
    np.testing.assert_allclose(lse.numpy(), want64.numpy(), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("d", [288, 300])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_model_lse_matches_the_jax_kernel(d, kind):
    """The fold's LSE (cap 30), from the slab of the inputs, against the
    JAX ``eval_fused`` in interpret mode on those inputs (its own product
    and fold), at ``tests/test_torch_bf16.py``'s tolerance and within
    1e-5 relative; its counts equal the JAX kernel's."""
    n, c, c_lo, c_hi = 8, 1_200, 1, 1_150
    rng, s_slab, (x, y) = _slab_problem(d + n, n, c, d, kind)
    t = rng.integers(c_lo, c_hi, n).astype(np.int32)
    tt = torch.from_numpy(t)
    tgt = s_slab[tt.long(), torch.arange(n)]
    got = _sweep_model(s_slab, tt, tgt, 1, c_lo, c_hi, CAP,
                       kernel.slab_sweep_plan(n, c, 1, 2))
    jguard.set_policy("off")  # its CPU canaries fail (ROADMAP queue 3)
    try:
        want = jeval.eval_fused(_jax(x), _jax(y), jnp.asarray(t), 1,
                                block_b=8,
                                block_c=64, interpret=True, c_lo=c_lo,
                                c_hi=c_hi, with_lse=True, logit_softcap=CAP)
    finally:
        jguard.set_policy(None)
    lse = got[4] + torch.log(got[5])
    wlse = np.asarray(want[5]) + np.log(np.asarray(want[6]))
    tb._close(lse, wlse)
    np.testing.assert_allclose(lse.numpy(), wlse, rtol=1e-5, atol=0)
    if kind == "bf16":  # one product on both sides: the same scores
        assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
        assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
