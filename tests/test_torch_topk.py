"""The port's top-k merge and plain ``mips_topk`` against the JAX package.

Both sides get the same numpy inputs. The merge does no arithmetic, so
it must agree bit for bit. ``mips_topk_ref`` is held against the Pallas
kernel in interpret mode: on integer-valued inputs every f32 fold order
is exact, so values, ids, tie order and ``ID_PAD`` tails must agree bit
for bit; on generic floats values agree within ``1e-5·max|score|`` (the
two frameworks fold the dot products in another order) and ids agree
wherever neighbouring scores are further apart than that.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mips_topk as jax_mips
from repro.kernels import topk_merge as jax_merge
from repro_torch.kernels import mips_topk as kernel
from repro_torch.kernels import ops, ref, topk_merge


def _inputs(rng, n_q, c, d, integer):
    if integer:
        q = rng.integers(-2, 3, size=(n_q, d)).astype(np.float32)
        y = rng.integers(-2, 3, size=(c, d)).astype(np.float32)
    else:
        q = rng.normal(size=(n_q, d)).astype(np.float32)
        y = rng.normal(size=(c, d)).astype(np.float32)
    return q, y


def assert_topk_match(got, want, scale, *, exact):
    """``got``/``want`` are numpy (vals, ids). Exact: bitwise. Otherwise
    values within 1e-5·scale and ids equal where the value is isolated
    from its in-list neighbours by more than that."""
    gv, gi = got
    wv, wi = want
    assert gv.shape == wv.shape and gi.shape == wi.shape
    assert gi.dtype == np.int32
    if exact:
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gi, wi)
        return
    tol = 1e-5 * scale
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol)
    prv = np.concatenate([np.full_like(wv[:, :1], np.inf), wv[:, :-1]], 1)
    nxt = np.concatenate([wv[:, 1:], np.full_like(wv[:, :1], -np.inf)], 1)
    isolated = ((prv - wv) > tol) & ((wv - nxt) > tol)
    np.testing.assert_array_equal(gi[isolated], wi[isolated])


# ---------------------------------------------------------------------------
# merge_topk_tile
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("integer", [True, False], ids=["int_ties", "float"])
def test_merge_topk_tile_matches_jax(integer):
    rng = np.random.default_rng(1)
    rows, k, tile = 5, 6, 9
    pv = np.full((rows, k), topk_merge.NEG_INF, np.float32)
    pi = np.full((rows, k), topk_merge.ID_PAD, np.int32)
    tv, ti = torch.from_numpy(pv), torch.from_numpy(pi)
    jv, ji = jnp.asarray(pv), jnp.asarray(pi)
    for t in range(3):
        s = (rng.integers(-2, 3, size=(rows, tile)) if integer
             else rng.normal(size=(rows, tile))).astype(np.float32)
        s[rng.random(s.shape) < 0.3] = topk_merge.NEG_INF  # masked columns
        s[0] = topk_merge.NEG_INF  # an exhausted row
        col = np.broadcast_to(
            np.arange(t * tile, (t + 1) * tile, dtype=np.int32), s.shape
        )
        tv, ti = topk_merge.merge_topk_tile(
            tv, ti, torch.from_numpy(s), torch.from_numpy(col.copy()), k
        )
        jv, ji = jax_merge.merge_topk_tile(
            jv, ji, jnp.asarray(s), jnp.asarray(col), k
        )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti[0] == topk_merge.ID_PAD).all()  # exhausted → ID_PAD
    assert topk_merge.ID_PAD == int(jax_merge.ID_PAD)
    assert topk_merge.NEG_INF == jax_merge.NEG_INF


def test_streaming_topk_elements_matches_jax():
    for rows, k, block in ((8, 10, 512), (512, 256, 64), (1, 1, 1)):
        assert topk_merge.streaming_topk_elements(rows, k, block) == \
            jax_merge.streaming_topk_elements(rows, k, block)


def test_merge_topk_tile_tie_rule_is_order_free():
    """Lower id wins among equal values even when the buffer's ids are
    larger than the tile's (the kernel's split merge relies on it)."""
    vals = torch.tensor([[3.0, 1.0]])
    ids = torch.tensor([[50, 51]], dtype=torch.int32)
    tile_v = torch.tensor([[1.0, 3.0, 2.0]])
    tile_i = torch.tensor([[7, 9, 8]], dtype=torch.int32)
    v, i = topk_merge.merge_topk_tile(vals, ids, tile_v, tile_i, 4)
    assert v.tolist() == [[3.0, 3.0, 2.0, 1.0]]
    assert i.tolist() == [[9, 50, 8, 7]]


# ---------------------------------------------------------------------------
# mips_topk_ref against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
# (name, n_q, C, d, k, integer, valid, id_offset, block_c)
CASES = [
    ("int_ties_c_tail", 6, 203, 8, 12, True, None, 0, 64),
    ("float_generic", 8, 300, 16, 10, False, None, 0, 128),
    ("int_k_gt_c", 4, 7, 8, 12, True, None, 0, 4),
    ("int_starved_offset", 5, 40, 8, 8, True, "starved", 1000, 16),
    ("float_valid_offset", 7, 150, 16, 9, False, "random", 77, 64),
]


@pytest.mark.parametrize(
    "name,n_q,c,d,k,integer,valid,id_offset,block_c", CASES,
    ids=[c[0] for c in CASES],
)
def test_mips_topk_ref_matches_jax_kernel(name, n_q, c, d, k, integer, valid,
                                          id_offset, block_c):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q, y = _inputs(rng, n_q, c, d, integer)
    vm = None
    if valid == "starved":
        vm = np.zeros(c, bool)
        vm[rng.choice(c, size=k - 3, replace=False)] = True
    elif valid == "random":
        vm = rng.random(c) > 0.4
    want = jax_mips.mips_topk(
        jnp.asarray(q), jnp.asarray(y), k,
        valid=None if vm is None else jnp.asarray(vm),
        block_q=8, block_c=block_c, id_offset=id_offset, interpret=True,
    )
    got = ref.mips_topk_ref(
        torch.from_numpy(q), torch.from_numpy(y), k,
        valid=None if vm is None else torch.from_numpy(vm),
        chunk=block_c, id_offset=id_offset,
    )
    scale = np.abs(q @ y.T).max()
    assert_topk_match(
        (got[0].numpy(), got[1].numpy()),
        (np.asarray(want[0]), np.asarray(want[1])), scale, exact=integer,
    )
    if valid == "starved":
        assert (got[1][:, -3:] == topk_merge.ID_PAD).all()


def test_mips_topk_ref_chunk_invariant():
    """The plain version's answer does not depend on its chunk size."""
    rng = np.random.default_rng(3)
    q, y = _inputs(rng, 4, 97, 8, True)
    q, y = torch.from_numpy(q), torch.from_numpy(y)
    base = ref.mips_topk_ref(q, y, 11, chunk=97)
    for chunk in (1, 5, 32, 512):
        v, i = ref.mips_topk_ref(q, y, 11, chunk=chunk)
        assert torch.equal(v, base[0]) and torch.equal(i, base[1])


# ---------------------------------------------------------------------------
# The kernel's decomposition, on the CPU: plan + per-split lists + merge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_q,c,d,k", [
    (8, 173_520, 64, 10), (32, 173_520, 64, 10), (512, 173_520, 64, 10),
    (40, 20_000, 128, 256), (40, 30_000, 256, 256), (3, 7, 64, 7),
    (1, 1, 1, 1), (100, 1_037, 33, 17),
    # SCE training's selections and the k cap (the merge-path plan)
    (320, 25_600, 64, 320), (320, 173_520, 64, 256), (64, 20_000, 256, 512),
])
def test_plan_covers_catalog_within_shared_memory(n_q, c, d, k):
    """The tensor-core sweep's plan (``mips_topk`` at k ≤ 32,
    ``eval_fused`` and ``eval_topk`` at every k) and, above k = 32, the
    plan of the f32 FMA sweep that finishes ``mips_topk``'s overflowing
    rows: whole tiles covering the catalog, a block within 227 KB, and
    at least one block per SM where the catalog has that many tiles."""
    p = kernel.sweep_plan(n_q, c, d, k, n_sm=132)
    assert p.query_tiles in kernel.QUERY_TILES
    bounds = [kernel.split_bounds(c, p.n_split, s) for s in range(p.n_split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == c
    assert all(lo % kernel.TILE_C == 0 and lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert kernel.sweep_smem_bytes(p.query_tiles, d, k) <= kernel.MAX_SMEM
    blocks = -(-n_q // (8 * p.query_tiles)) * p.n_split
    assert blocks >= min(132, -(-c // kernel.TILE_C))
    if k > kernel.SMALL_K:
        f = kernel.plan(n_q, c, d, k, n_sm=132)
        assert f.split_cols % kernel.TILE_C == 0
        assert (f.n_split - 1) * f.split_cols < c <= f.n_split * f.split_cols
        assert kernel.partial_smem_bytes(1, d, k) <= kernel.MAX_SMEM
        blocks = -(-n_q // 16) * f.n_split
        assert blocks >= min(132, -(-c // kernel.TILE_C))


def test_split_lists_merge_to_the_single_pass():
    """What the kernel pair computes — per-split top-k lists (ids offset
    by the split start), merged by the same key — equals one pass."""
    rng = np.random.default_rng(4)
    n_q, c, d, k = 6, 1_000, 8, 9
    q, y = (torch.from_numpy(a) for a in _inputs(rng, n_q, c, d, True))
    valid = torch.from_numpy(rng.random(c) > 0.2)
    p = kernel.sweep_plan(n_q, c, d, k, n_sm=4)
    assert p.n_split > 1
    vals = torch.full((n_q, k), topk_merge.NEG_INF)
    ids = torch.full((n_q, k), topk_merge.ID_PAD, dtype=torch.int32)
    for s in range(p.n_split):
        lo, hi = kernel.split_bounds(c, p.n_split, s)
        sv, si = ref.mips_topk_ref(q, y[lo:hi], k, valid=valid[lo:hi],
                                   id_offset=100 + lo)
        vals, ids = topk_merge.merge_topk_tile(vals, ids, sv, si, k)
    want = ref.mips_topk_ref(q, y, k, valid=valid, id_offset=100)
    assert torch.equal(vals, want[0]) and torch.equal(ids, want[1])


# ---------------------------------------------------------------------------
# The k > 32 chain, on the CPU: threshold, collect, select (or the split
# sweep for a row that overflows)
# ---------------------------------------------------------------------------
KEEP = kernel.UNION_PER_SPLIT // 16  # kKeep: entries a thread keeps per row


def _key_order(v, i):
    """``(v, i)`` rows sorted by the key (value desc, id asc), pads kept."""
    by_id = torch.sort(i, dim=-1, stable=True).indices
    v, i = torch.gather(v, -1, by_id), torch.gather(i, -1, by_id)
    order = torch.sort(v, dim=-1, descending=True, stable=True).indices
    return torch.gather(v, -1, order), torch.gather(i, -1, order)


def _chain_model(q, y, k, valid, id_offset, sp, fin):
    """What the kernel chain computes, from ``ref.mips_topk_ref`` on the
    column sets the kernels see: each (split, lane)'s best ``KEEP`` over
    tiles ``s, s + period, …`` and columns ``lane + 16·j``; τ = the k-th
    of their union; every valid column whose key precedes or equals τ;
    the first k of those by the key — or, for a row that collected more
    than ``kcap``, the merged lists of the split sweep. Returns (vals,
    ids, counts)."""
    n_q, c = q.shape[0], y.shape[0]
    tiles = -(-c // kernel.TILE_C)
    ok = torch.ones(c, dtype=torch.bool) if valid is None else valid
    uv, ui = [], []
    for s in range(sp.n_split):
        for lane in range(16):
            cols = torch.tensor([t * 64 + lane + 16 * j
                                 for t in range(s, tiles, sp.period)
                                 for j in range(4)
                                 if t * 64 + lane + 16 * j < c], dtype=torch.long)
            v = torch.full((n_q, KEEP), topk_merge.NEG_INF)
            i = torch.full((n_q, KEEP), topk_merge.ID_PAD, dtype=torch.int32)
            if len(cols):
                bv, bi = ref.mips_topk_ref(q, y[cols], KEEP, valid=ok[cols])
                real = bi != topk_merge.ID_PAD
                glob = (id_offset + cols[bi.clamp(max=len(cols) - 1).long()])
                v[:, :bv.shape[1]] = bv
                i[:, :bi.shape[1]] = torch.where(real, glob.to(torch.int32),
                                                 bi)
            uv.append(v)
            ui.append(i)
    uv, ui = _key_order(torch.cat(uv, 1), torch.cat(ui, 1))
    if uv.shape[1] < k:  # fewer than k entries: τ is a pad
        uv = torch.cat([uv, torch.full((n_q, k), topk_merge.NEG_INF)], 1)
        ui = torch.cat([ui, torch.full((n_q, k), topk_merge.ID_PAD,
                                       dtype=torch.int32)], 1)
    tv, ti = uv[:, k - 1:k], ui[:, k - 1:k]
    s = q @ y.T
    col = torch.arange(id_offset, id_offset + c, dtype=torch.int32)[None]
    take = ok[None] & ((s > tv) | ((s == tv) & (col <= ti)))  # ⪯ τ
    counts = take.sum(1)
    vals = torch.empty(n_q, k)
    ids = torch.empty(n_q, k, dtype=torch.int32)
    for r in range(n_q):
        if counts[r] > sp.kcap:  # the split sweep finishes the row
            v = torch.full((1, k), topk_merge.NEG_INF)
            i = torch.full((1, k), topk_merge.ID_PAD, dtype=torch.int32)
            for lo in range(0, c, fin.split_cols):
                hi = min(c, lo + fin.split_cols)
                lv, li = ref.mips_topk_ref(q[r:r + 1], y[lo:hi], k,
                                           valid=ok[lo:hi],
                                           id_offset=id_offset + lo)
                v, i = topk_merge.merge_topk_tile(v, i, lv, li, k)
        else:
            pad = max(0, k - int(counts[r]))
            v, i = _key_order(
                torch.cat([s[r][take[r]],
                           torch.full((pad,), topk_merge.NEG_INF)])[None],
                torch.cat([col[0][take[r]],
                           torch.full((pad,), topk_merge.ID_PAD,
                                      dtype=torch.int32)])[None])
            v, i = v[:, :k], i[:, :k]
            i = torch.where(v == topk_merge.NEG_INF,
                            torch.full_like(i, topk_merge.ID_PAD), i)
        vals[r], ids[r] = v[0], i[0]
    return vals, ids, counts


def _clustered(rng, n_q, c, d, period, residue):
    """Integer inputs whose best columns all lie in the tiles ``t`` with
    ``t % period == residue``: positive queries, boosted rows there."""
    q = rng.integers(1, 3, size=(n_q, d)).astype(np.float32)
    y = rng.integers(-2, 3, size=(c, d)).astype(np.float32)
    tile = np.arange(c) // kernel.TILE_C
    hot = tile % period == residue
    y[hot] = rng.integers(3, 6, size=(int(hot.sum()), d))
    return q, y


# (name, n_q, C, d, k, n_sm, inputs, valid, id_offset, kcap, overflow)
CHAIN_CASES = [
    # the best columns in one residue of the tiles: one the threshold pass
    # samples (one split holds them, the union 32 of them: τ falls below
    # the cluster), one it skips; both collect the whole cluster and
    # overflow into the split sweep
    ("clustered_sampled_residue", 6, 12_800, 8, 40, 4, "hot_in", None, 0,
     None, True),
    ("clustered_skipped_residue", 6, 12_800, 8, 40, 4, "hot_out", None, 0,
     None, True),
    ("all_equal", 5, 2_000, 8, 100, 4, "ones", None, 9, None, False),
    ("fewer_valid_than_k", 7, 3_000, 8, 320, 4, "ints", "starved", 3, None,
     False),
    ("k_equals_c", 4, 300, 8, 300, 132, "ints", "random", 0, None, False),
    ("k512", 3, 20_000, 8, 512, 32, "ints", "random", 0, None, False),
    # an all-equal row collects ≈ 4k > kcap; the other rows fit
    ("overflow_row", 8, 5_000, 8, 40, 132, "zero_row", None, 100, 64, True),
]


@pytest.mark.parametrize(
    "name,n_q,c,d,k,n_sm,inputs,valid,id_offset,kcap,overflow", CHAIN_CASES,
    ids=[c[0] for c in CHAIN_CASES],
)
def test_select_chain_equals_the_single_pass(name, n_q, c, d, k, n_sm,
                                             inputs, valid, id_offset, kcap,
                                             overflow):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    sp = kernel.select_plan(n_q, c, d, k, n_sm)
    if kcap is not None:
        sp = kernel.SelectPlan(sp.n_split, sp.period, sp.collect_split, kcap)
    if inputs.startswith("hot"):
        assert sp.period > sp.n_split  # a sampled threshold pass
        residue = 1 if inputs == "hot_in" else sp.n_split + 1
        q, y = _clustered(rng, n_q, c, d, sp.period, residue)
    elif inputs == "ones":
        q, y = np.ones((n_q, d), np.float32), np.ones((c, d), np.float32)
    else:
        q, y = _inputs(rng, n_q, c, d, True)
        if inputs == "zero_row":
            q[3] = 0.0
    vm = None
    if valid == "starved":
        vm = np.zeros(c, bool)
        vm[rng.choice(c, size=50, replace=False)] = True
    elif valid == "random":
        vm = rng.random(c) > 0.3
    q, y = torch.from_numpy(q), torch.from_numpy(y)
    vm = None if vm is None else torch.from_numpy(vm)
    vals, ids, counts = _chain_model(q, y, min(k, c), vm, id_offset, sp,
                                     kernel.plan(n_q, c, d, k, n_sm))
    want = ref.mips_topk_ref(q, y, k, valid=vm, id_offset=id_offset)
    assert torch.equal(vals, want[0]) and torch.equal(ids, want[1])
    assert bool((counts > sp.kcap).any()) == overflow
    if name == "overflow_row":
        assert counts[3] > sp.kcap and (counts <= sp.kcap).sum() >= 1
    if valid == "starved":
        assert (ids[:, 50:] == topk_merge.ID_PAD).all()


def test_guard_large_k_canary_drives_both_paths():
    """The kernel guard's ``large_k_select_overflow`` canary, modelled at
    an H100's plan (132 SMs): its all-ties row 3 overflows the 60-entry
    collect buffer into the split sweep while the others take the
    select, and its starved mask leaves every row below k."""
    from repro_torch.kernels.guard import conformance as conf

    q, y, valid, starved = conf._large_k_inputs(torch.device("cpu"))
    n_q, c, d, k = q.shape[0], y.shape[0], q.shape[1], conf.LARGE_K
    fin = kernel.plan(n_q, c, d, k, 132)
    sp = kernel.select_plan(n_q, c, d, k, 132)
    vals, ids, counts = _chain_model(
        q, y, k, valid, 11,
        kernel.SelectPlan(sp.n_split, sp.period, sp.collect_split,
                          conf.LARGE_K_CAP), fin)
    want = ref.mips_topk_ref(q, y, k, valid=valid, id_offset=11)
    assert torch.equal(vals, want[0]) and torch.equal(ids, want[1])
    over = counts > conf.LARGE_K_CAP
    assert over.tolist() == [r == 3 for r in range(n_q)]
    vals, ids, counts = _chain_model(q, y, k, starved, 11, sp, fin)
    assert (counts == 30).all() and (ids[:, 30:] == topk_merge.ID_PAD).all()


@pytest.mark.parametrize("d", [1, 8, 33, 64, 128, 255, 256])
def test_select_plan_fits_shared_memory_and_covers_k(d):
    """For every k in (32, 512]: each launch of the chain fits 227 KB,
    the union can hold k entries (16 per split) unless the catalog has
    fewer tiles than that needs, and kcap ≥ k is a power of two that the
    sorts take."""
    for n_q in (1, 64, 320, 4_096):
        for c in (600, 25_600, 173_520):
            tiles = -(-c // kernel.TILE_C)
            for k in range(kernel.SMALL_K + 1, kernel.MAX_K + 1):
                if k > c:
                    continue
                sp = kernel.select_plan(n_q, c, d, k, 132)
                assert kernel.select_smem(n_q, c, d, k, 132) <= \
                    kernel.MAX_SMEM
                assert kernel.planned_smem(n_q, c, d, k, 132) == \
                    kernel.select_smem(n_q, c, d, k, 132)
                assert kernel.UNION_PER_SPLIT * sp.n_split >= k or \
                    sp.n_split == tiles
                assert kernel.UNION_PER_SPLIT * sp.n_split <= \
                    kernel.MAX_SORT
                assert sp.n_split <= sp.period <= tiles
                assert k <= sp.kcap <= kernel.MAX_SORT
                assert sp.kcap & (sp.kcap - 1) == 0
                assert 1 <= sp.collect_split <= tiles


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------
def test_ops_cpu_takes_plain_version_and_leaves_counter():
    rng = np.random.default_rng(5)
    q, y = (torch.from_numpy(a) for a in _inputs(rng, 3, 50, 8, False))
    before = kernel.mips_topk.launches
    got = ops.mips_topk(q, y, 5, id_offset=3)
    want = ref.mips_topk_ref(q, y, 5, id_offset=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernel.mips_topk.launches == before == 0


def test_kernel_wrapper_and_ops_refuse_non_cuda():
    q, y = torch.zeros(2, 4), torch.zeros(5, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.mips_topk(q, y, 3)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.mips_topk(q.to("meta"), y.to("meta"), 3)
    assert kernel.mips_topk.launches == 0
