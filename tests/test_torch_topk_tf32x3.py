"""The arithmetic and the shared threshold of the 3xTF32 catalog sweep,
on the CPU.

``csrc/topk_tile.cuh``'s sweep (``mips_topk`` at k ≤ 32, ``eval_fused``
and ``eval_topk`` at every k) scores on the tensor cores in 3xTF32: each
f32 input is split into ``hi = tf32(a)`` and ``lo = tf32(a − hi)`` (the
planes of ``ref.tf32x3_planes_ref``), catalog rows are ``mma``'s A and
query rows its B, and each k16 step of the depth (depths 16s … 16s + 15)
sums the small terms of both k8 steps, then the large ones, from zero,
before it is added to the f32 total. ``eval_tgt_gather`` and
``eval_tgt_scores`` run the same steps for one pair, so a target's score
is the swept column's. A CUDA kernel has no CPU mode, so this file holds
a plain, test-only model of that score (``_tf32x3_scores``: each product
of two TF32 values is exact, each step's sum is taken in f64 and rounded
to f32 once, as the tensor cores' inner sum is the step's only rounding
up to a few units in its last place) and of the sweep's shared threshold
(``_sweep_model``), as evidence before the card:

- the model's scores lie within ``1e-5·max|score|`` of the f64 product
  (the chip tolerance of ``test_torch_cuda.py``), and equal it exactly on
  integer inputs (|v| ≤ 2: every split is its own ``hi``, every sum
  exact);
- top-k from the model's scores agree with the JAX ``mips_topk`` kernel
  in interpret mode — ids and values bit for bit on integer inputs, ids
  wherever neighbouring scores are further apart than the tolerance on
  floats — and ``gt`` / ``eq`` against the model's own target score give
  the JAX ``eval_fused`` kernel's ranks (interpret mode): exactly on
  integer inputs, and on floats on every row whose target has no other
  score within the tolerance, the rest inside the f64 band;
- the shared threshold: blocks that sweep their splits in any
  interleaving, read τ whenever they filter, merge a row's buffer only
  past ``kMergeAt`` candidates or at the end and publish their lists'
  k-th value with a max, then a merge that skips entries below the final
  τ — give the single pass, on ties, a starved mask and k past the
  valid columns too;
- the pre-pass's τ (``_prepass_tau``: the k-th of the union of each
  lane's best column over a strided quarter of the tiles) is at most the
  row's k-th score, and the sweep started from it gives the single pass;
- the plan (``mips_topk.sweep_plan``) cuts the catalog into balanced
  whole-tile splits that cover it, fits a block within 232,448 bytes and
  its blocks an SM's 233,472, for every d ≤ 256 and k ≤ 512, and keeps a
  pre-pass (k ≤ 32 only) within its union's and selection's bounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import eval_fused as jax_eval
from repro.kernels import mips_topk as jax_mips
from repro_torch.kernels import mips_topk as kernel
from repro_torch.kernels import ref
from repro_torch.kernels.topk_merge import ID_PAD, NEG_INF

from _rank_band import f64_band

TOL = 1e-5  # of max|score|: the chip tolerance
MERGE_AT = kernel.SWEEP_CAP - kernel.TILE_C  # kMergeAt in the source


def _planes(a):
    """``(hi, lo)`` of ``a`` (rows, d) at the depth rounded up to 16."""
    p = ref.tf32x3_planes_ref(a)
    rows = a.shape[0]
    return p[:, :, 0, :].reshape(rows, -1), p[:, :, 1, :].reshape(rows, -1)


def _tf32x3_scores(q, y):
    """``(n_q, C)`` f32 scores as the sweep takes them: per k16 step of the
    depth, the small terms (lo·hi + hi·lo) then the large ones (hi·hi)
    summed from zero — exact products, the sum in f64, one rounding to
    f32 — added to the f32 total in step order."""
    qh, ql = _planes(q)
    yh, yl = _planes(y)
    out = torch.zeros(q.shape[0], y.shape[0], dtype=torch.float32)
    for s in range(0, qh.shape[1], 16):
        st = slice(s, s + 16)
        a_hi, a_lo = yh[:, st].double(), yl[:, st].double()
        b_hi, b_lo = qh[:, st].double(), ql[:, st].double()
        step = (b_hi @ a_lo.T + b_lo @ a_hi.T) + b_hi @ a_hi.T
        out = out + step.float()
    return out


def _inputs(seed, n_q, c, d, integer):
    rng = np.random.default_rng(seed)
    if integer:
        q = rng.integers(-2, 3, size=(n_q, d)).astype(np.float32)
        y = rng.integers(-2, 3, size=(c, d)).astype(np.float32)
    else:
        q = rng.normal(size=(n_q, d)).astype(np.float32)
        y = rng.normal(size=(c, d)).astype(np.float32)
    return q, y


def _topk(scores, k, valid=None, id_offset=0):
    """Top-``k`` of a dense score matrix under (value desc, id asc), pads
    ``(NEG_INF, ID_PAD)``: the plain version's merge on one chunk."""
    c = scores.shape[1]
    if valid is not None:
        scores = torch.where(valid[None, :], scores, NEG_INF)
    ids = torch.arange(id_offset, id_offset + c, dtype=torch.int32)
    vals = torch.full((scores.shape[0], k), NEG_INF)
    out = torch.full((scores.shape[0], k), ID_PAD, dtype=torch.int32)
    from repro_torch.kernels.topk_merge import merge_topk_tile

    return merge_topk_tile(vals, out, scores, ids.expand_as(scores), k)


def _assert_topk(gv, gi, wv, wi, scale, exact):
    if exact:
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gi, wi)
        return
    tol = TOL * scale
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol)
    prv = np.concatenate([np.full_like(wv[:, :1], np.inf), wv[:, :-1]], 1)
    nxt = np.concatenate([wv[:, 1:], np.full_like(wv[:, :1], -np.inf)], 1)
    isolated = ((prv - wv) > tol) & ((wv - nxt) > tol)
    np.testing.assert_array_equal(gi[isolated], wi[isolated])


# ---------------------------------------------------------------------------
# The score
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_q,c,d,integer,scale", [
    (8, 700, 64, False, 1.0), (5, 300, 33, False, 1.0),
    (4, 200, 256, False, 1.0), (6, 500, 64, False, 3.0),
    (8, 700, 64, True, 1.0), (3, 90, 7, True, 1.0),
])
def test_tf32x3_score_is_near_f64(n_q, c, d, integer, scale):
    q, y = _inputs(n_q * 13 + c + d, n_q, c, d, integer)
    q = q * np.float32(scale)
    got = _tf32x3_scores(torch.from_numpy(q), torch.from_numpy(y)).double()
    want = torch.from_numpy(q).double() @ torch.from_numpy(y).double().T
    if integer:
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().max().item()
        assert err <= TOL * want.abs().max().item()
        # and no farther from f64 than a few units of the f32 product's
        f32 = (torch.from_numpy(q) @ torch.from_numpy(y).T).double()
        assert err <= 4 * (f32 - want).abs().max().item() + 1e-12


@pytest.mark.parametrize("n_q,c,d,k,integer,valid,id_offset", [
    (8, 300, 64, 10, False, None, 0),
    (8, 203, 33, 12, True, None, 0),
    (7, 150, 16, 9, False, "random", 77),
    (5, 40, 8, 8, True, "starved", 1000),
])
def test_tf32x3_topk_matches_jax_mips_topk(n_q, c, d, k, integer, valid,
                                           id_offset):
    rng = np.random.default_rng(n_q + c + d)
    q, y = _inputs(c * 7 + d, n_q, c, d, integer)
    vm = None
    if valid == "starved":
        vm = np.zeros(c, bool)
        vm[rng.choice(c, size=k - 3, replace=False)] = True
    elif valid == "random":
        vm = rng.random(c) > 0.4
    want = jax_mips.mips_topk(
        jnp.asarray(q), jnp.asarray(y), k,
        valid=None if vm is None else jnp.asarray(vm),
        block_q=8, block_c=64, id_offset=id_offset, interpret=True)
    s = _tf32x3_scores(torch.from_numpy(q), torch.from_numpy(y))
    gv, gi = _topk(s, k, None if vm is None else torch.from_numpy(vm),
                   id_offset)
    _assert_topk(gv.numpy(), gi.numpy(), np.asarray(want[0]),
                 np.asarray(want[1]), float(np.abs(q @ y.T).max()), integer)


@pytest.mark.parametrize("n,c,d,k,integer,c_lo,c_hi,id_offset", [
    (16, 700, 32, 10, True, 1, 690, 0),
    (16, 700, 32, 10, False, 1, 690, 0),
    (12, 1037, 24, 10, False, 3, 1030, 0),
    (10, 600, 16, 8, True, 1003, 1550, 1000),
])
def test_tf32x3_ranks_match_jax_eval_fused(n, c, d, k, integer, c_lo, c_hi,
                                           id_offset):
    rng = np.random.default_rng(n * 31 + c)
    x, y = _inputs(n + c + d, n, c, d, integer)
    lo = max(c_lo, id_offset)
    t = rng.integers(lo, min(c_hi, id_offset + c), size=n).astype(np.int32)
    want = jax_eval.eval_fused(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(t), k, block_b=8, block_c=128,
                               c_lo=c_lo, c_hi=c_hi, id_offset=id_offset,
                               interpret=True)
    s = _tf32x3_scores(torch.from_numpy(x), torch.from_numpy(y))
    gid = id_offset + torch.arange(c)
    ok = (gid >= c_lo) & (gid < c_hi)
    tt = torch.from_numpy(t).long()
    tgt = s[torch.arange(n), tt - id_offset]  # the model's own column
    sv = torch.where(ok[None, :], s, NEG_INF)
    self_col = gid[None, :] == tt[:, None]
    gt = ((sv > tgt[:, None]) & ~self_col).sum(1).numpy()
    eq = ((sv == tgt[:, None]) | (self_col & ok[None, :])).sum(1).numpy()
    ranks = gt + np.maximum(eq - 1, 0)
    w_ranks = np.asarray(want[2]) + np.maximum(np.asarray(want[3]) - 1, 0)
    scale = float(np.abs(x.astype(np.float64) @ y.T.astype(np.float64)).max())
    gv, gi = _topk(s, k, ok, id_offset)
    _assert_topk(gv.numpy(), gi.numpy(), np.asarray(want[0]),
                 np.asarray(want[1]), scale, integer)
    assert (eq >= 1).all()
    if integer:
        np.testing.assert_array_equal(ranks, w_ranks)
        return
    band_lo, band_hi = f64_band(x, y, t, c_lo, c_hi, id_offset, TOL * scale)
    clear = band_lo == band_hi  # no other score within tol of the target
    assert clear.sum() >= n // 2
    np.testing.assert_array_equal(ranks[clear], w_ranks[clear])
    assert ((ranks >= band_lo) & (ranks <= band_hi)).all()


# ---------------------------------------------------------------------------
# The shared threshold
# ---------------------------------------------------------------------------
def _sweep_model(s, valid, k, n_split, rng, id_offset=0, tau0=None):
    """The sweep's selection on a dense f32 score matrix ``s`` (n_q, C):
    ``n_split`` blocks (each all the rows, its balanced tiles in order)
    interleaved at random, a tile at a time. Before a tile a block merges
    every row whose buffer holds more than ``MERGE_AT`` candidates (the
    buffer compacted to s ≥ τ and ahead of the list's k-th entry first);
    its filter appends every valid score ≥ max(τ, the list's k-th value);
    a merge whose list's k-th entry is real raises τ to its value. At the
    end each block merges every buffer; the split lists are merged,
    entries below the final τ skipped. ``tau0``: τ as a pre-pass seeded
    it (default: no threshold). → (vals, ids) (n_q, k)."""
    n_q, c = s.shape
    s = s.numpy()
    valid = np.ones(c, bool) if valid is None else valid.numpy()
    tau = (np.full(n_q, -3.39e38, np.float32) if tau0 is None
           else tau0.copy())
    key = lambda v, i: (-v, i)  # noqa: E731
    blocks = []
    for b in range(n_split):
        lo, hi = kernel.split_bounds(c, n_split, b)
        tiles = [(t0, min(t0 + kernel.TILE_C, hi))
                 for t0 in range(lo, hi, kernel.TILE_C)]
        blocks.append({"tiles": tiles, "next": 0,
                       "list": [[] for _ in range(n_q)],
                       "buf": [[] for _ in range(n_q)]})

    def kth(lst):
        return lst[k - 1] if len(lst) == k else (NEG_INF, ID_PAD)

    def merge(blk, r):
        kv, ki = kth(blk["list"][r])
        keep = [(v, i) for v, i in blk["buf"][r]
                if v >= tau[r] and key(v, i) < key(kv, ki)]
        merged = sorted(blk["list"][r] + keep, key=lambda e: key(*e))[:k]
        blk["list"][r] = merged
        blk["buf"][r] = []
        if len(merged) == k:
            tau[r] = max(tau[r], merged[-1][0])

    live = list(range(n_split))
    while live:
        b = live[rng.integers(len(live))]
        blk = blocks[b]
        if blk["next"] == len(blk["tiles"]):
            for r in range(n_q):
                merge(blk, r)
            live.remove(b)
            continue
        for r in range(n_q):
            if len(blk["buf"][r]) > MERGE_AT:
                merge(blk, r)
        c0, c1 = blk["tiles"][blk["next"]]
        blk["next"] += 1
        for r in range(n_q):
            thr = max(float(tau[r]), kth(blk["list"][r])[0])
            for cc in range(c0, c1):
                v = float(s[r, cc])
                if valid[cc] and v >= thr:
                    blk["buf"][r].append((v, id_offset + cc))
            assert len(blk["buf"][r]) <= kernel.SWEEP_CAP
    vals = np.full((n_q, k), NEG_INF, np.float32)
    ids = np.full((n_q, k), ID_PAD, np.int32)
    for r in range(n_q):
        pool = [e for blk in blocks for e in blk["list"][r] if e[0] >= tau[r]]
        for j, (v, i) in enumerate(sorted(pool, key=lambda e: key(*e))[:k]):
            vals[r, j] = v
            ids[r, j] = i if v != NEG_INF else ID_PAD
    return torch.from_numpy(vals), torch.from_numpy(ids)


@pytest.mark.parametrize("name,n_q,c,d,k,integer,valid,n_split", [
    ("floats", 6, 2_000, 16, 10, False, None, 7),
    ("integer_ties", 5, 1_500, 8, 12, True, None, 9),
    ("all_equal", 3, 700, 4, 10, "ones", None, 5),
    ("starved", 4, 900, 8, 10, False, "starved", 6),
    ("k_past_valid", 3, 400, 8, 32, True, "few", 4),
    ("one_split", 4, 500, 8, 10, False, "random", 1),
])
def test_shared_threshold_gives_the_single_pass(name, n_q, c, d, k, integer,
                                                valid, n_split):
    rng = np.random.default_rng(len(name) * 101 + c)
    q, y = _inputs(c + n_q, n_q, c, d, integer is True)
    if integer == "ones":
        q, y = np.ones_like(q), np.ones_like(y)
    vm = None
    if valid == "starved":
        vm = np.zeros(c, bool)
        vm[rng.choice(c, size=k - 4, replace=False)] = True
    elif valid == "few":
        vm = np.zeros(c, bool)
        vm[rng.choice(c, size=k + 5, replace=False)] = True
    elif valid == "random":
        vm = rng.random(c) > 0.3
    s = _tf32x3_scores(torch.from_numpy(q), torch.from_numpy(y))
    vm_t = None if vm is None else torch.from_numpy(vm)
    want = _topk(s, k, vm_t, 5)
    for seed in range(3):  # three interleavings of the blocks
        got = _sweep_model(s, vm_t, k, n_split, np.random.default_rng(seed),
                           id_offset=5)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _prepass_tau(s, valid, k, pre_split, period):
    """The pre-pass's τ: per row the k-th largest of the union of each
    lane's best valid score (NaN as +inf) — the lane (wm, gq) of a block of
    1 or 4 query tiles holds the tile rows whose offset, bit 3 cleared, is
    16·wm + gq — over the tiles b, b + period, … of blocks b < pre_split;
    −3.39e38 (no threshold) where fewer than k entries are real."""
    n_q, c = s.shape
    s = np.where(np.isnan(s.numpy()), np.inf, s.numpy())
    ok = np.ones(c, bool) if valid is None else valid.numpy()
    tiles = -(-c // kernel.TILE_C)
    union = []
    for b in range(pre_split):
        cols = np.concatenate([np.arange(t * kernel.TILE_C,
                                         min(c, (t + 1) * kernel.TILE_C))
                               for t in range(b, tiles, period)] or
                              [np.zeros(0, int)])
        group = (cols % kernel.TILE_C) & ~8
        for g in range(32):
            sel = cols[(group == g) & ok[cols]]
            union.append(s[:, sel].max(1) if sel.size
                          else np.full(n_q, -np.inf))
    u = np.sort(np.stack(union, 1), 1)[:, ::-1]
    kth = u[:, k - 1] if u.shape[1] >= k else np.full(n_q, -np.inf)
    return np.where(kth > -np.inf, kth, -3.39e38).astype(np.float32)


@pytest.mark.parametrize("name,n_q,c,d,k,integer,valid,pre_split", [
    ("floats", 6, 6_000, 16, 10, False, None, 6),
    ("integer_ties", 5, 5_000, 8, 12, True, "random", 7),
    ("all_equal", 3, 4_500, 4, 10, "ones", None, 5),
    ("starved", 4, 4_200, 8, 10, False, "starved", 4),
])
def test_prepass_threshold_gives_the_single_pass(name, n_q, c, d, k,
                                                  integer, valid, pre_split):
    """A τ seeded by the pre-pass (the k-th of the union of lanes' bests
    over a quarter of the tiles) is at most the row's k-th score, and the
    sweep model started from it gives the single pass."""
    rng = np.random.default_rng(len(name) * 7 + c)
    q, y = _inputs(c + d, n_q, c, d, integer is True)
    if integer == "ones":
        q, y = np.ones_like(q), np.ones_like(y)
    vm = None
    if valid == "starved":
        vm = np.zeros(c, bool)
        vm[rng.choice(c, size=k - 4, replace=False)] = True
    elif valid == "random":
        vm = rng.random(c) > 0.3
    s = _tf32x3_scores(torch.from_numpy(q), torch.from_numpy(y))
    vm_t = None if vm is None else torch.from_numpy(vm)
    want = _topk(s, k, vm_t, 5)
    tau0 = _prepass_tau(s, vm_t, k, pre_split, 4 * pre_split)
    assert (tau0 <= want[0][:, -1].numpy()).all()
    if valid != "starved":
        assert (tau0 > -3e38).all()
    for seed in range(2):
        got = _sweep_model(s, vm_t, k, 9, np.random.default_rng(seed),
                           id_offset=5, tau0=tau0)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [1, 8, 33, 64, 128, 255, 256])
def test_sweep_plan_covers_the_catalog_within_shared_memory(d):
    for n_q in (1, 8, 9, 32, 33, 128, 256, 512, 1_000):
        for k in (1, 10, 32, 33, 256, 257, 512):
            for c in (max(k, 7), 20_000, 173_520):
                p = kernel.sweep_plan(n_q, c, d, k, 132)
                smem = kernel.sweep_smem_bytes(p.query_tiles, d, k)
                assert smem <= kernel.MAX_SMEM
                per_sm = {1: 4, 4: 2, 16: 1}[p.query_tiles]
                assert min(per_sm, kernel.SM_SMEM // (smem + 1024)) >= 1
                bounds = [kernel.split_bounds(c, p.n_split, s)
                          for s in range(p.n_split)]
                assert bounds[0][0] == 0 and bounds[-1][1] == c
                assert all(lo % kernel.TILE_C == 0 and lo < hi
                           for lo, hi in bounds)
                assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
                tiles = -(-c // kernel.TILE_C)
                blocks = -(-n_q // (8 * p.query_tiles)) * p.n_split
                assert blocks >= min(132, tiles)
                if p.pre_split:  # the pre-pass: k ≤ 32, its union fits
                    assert k <= kernel.SMALL_K and p.pre_split <= p.n_split
                    assert p.pre_period == kernel.PRE_SAMPLE * p.pre_split
                    n_union = p.pre_split * 8 * kernel.SWEEP_WM[p.query_tiles]
                    assert n_union <= kernel.PRE_UNION
                    assert kernel.tau_select_smem_bytes(n_union) <= 48 * 1024
                assert kernel.sweep_smem(n_q, c, d, k, 132) <= kernel.MAX_SMEM
