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
    p = kernel.plan(n_q, c, d, k, n_sm=132)
    assert p.rows_per_thread in (1, 2, 4)
    assert p.split_cols % kernel.TILE_C == 0
    assert (p.n_split - 1) * p.split_cols < c <= p.n_split * p.split_cols
    assert kernel.partial_smem_bytes(p.rows_per_thread, d, k) <= kernel.MAX_SMEM
    blocks = -(-n_q // (16 * p.rows_per_thread)) * p.n_split
    assert blocks >= min(132, -(-c // kernel.TILE_C))


def test_split_lists_merge_to_the_single_pass():
    """What the kernel pair computes — per-split top-k lists (ids offset
    by the split start), merged by the same key — equals one pass."""
    rng = np.random.default_rng(4)
    n_q, c, d, k = 6, 1_000, 8, 9
    q, y = (torch.from_numpy(a) for a in _inputs(rng, n_q, c, d, True))
    valid = torch.from_numpy(rng.random(c) > 0.2)
    p = kernel.plan(n_q, c, d, k, n_sm=4)
    assert p.n_split > 1
    vals = torch.full((n_q, k), topk_merge.NEG_INF)
    ids = torch.full((n_q, k), topk_merge.ID_PAD, dtype=torch.int32)
    for s in range(p.n_split):
        lo, hi = s * p.split_cols, min(c, (s + 1) * p.split_cols)
        sv, si = ref.mips_topk_ref(q, y[lo:hi], k, valid=valid[lo:hi],
                                   id_offset=100 + lo)
        vals, ids = topk_merge.merge_topk_tile(vals, ids, sv, si, k)
    want = ref.mips_topk_ref(q, y, k, valid=valid, id_offset=100)
    assert torch.equal(vals, want[0]) and torch.equal(ids, want[1])


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
