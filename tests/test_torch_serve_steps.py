"""The seqrec serving steps on one device against the JAX package's
``mesh=None`` paths, on converted parameters: the MIPS serve step (both
encoders), ``make_seqrec_serve_step`` (top-100, only phantom rows
masked) and ``make_seqrec_retrieval_step`` (a candidate list re-ranked,
positions returned); ``RetrievalServer("bert4rec")``; and the bitonic
tile merge against the reference's and the port's K-round merge, with
``mips_topk``'s ``merge_impl``.

Values agree within ``1e-5·max|score|`` (the forwards fold f32 sums in
another order); ids agree exactly wherever the neighbouring dense scores
are further apart than that, and exactly tied items (duplicated catalog
rows, repeated candidates) come lower id, or earlier position, first on
both sides. The merges agree bit for bit: the same values, ids, tie
order and ``ID_PAD`` slots.
"""
import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import topk_merge as jax_merge
from repro.launch import steps as jax_steps
from repro.models import sasrec as jax_sasrec
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.topk_merge import (ID_PAD, NEG_INF, merge_fn,
                                            merge_topk_tile,
                                            merge_topk_tile_bitonic)
from repro_torch.launch import steps
from repro_torch.launch.serve import RetrievalServer
from repro_torch.models.convert import sasrec_params_from_jax

ARCHS = ("sasrec-sce", "bert4rec")
N_HIST = 6


def _setup(arch_name, seed=7):
    """The arch's smoke configs of both packages and JAX parameters as
    numpy arrays, 80 rows of the second half of the catalog copies of
    rows 1–80 (so whole rows tie); row 0 scaled up, so it reaches a
    top-100 unless masked."""
    jcfg = jax_get_arch(arch_name).make_smoke_config()
    cfg = get_arch(arch_name).make_smoke_config()
    params = jax.tree.map(
        np.array, jax_sasrec.init_params(jax.random.PRNGKey(seed), jcfg))
    half = jcfg.n_items // 2
    params["item_emb"][half:half + 80] = params["item_emb"][1:81]
    params["item_emb"][0] *= 4.0
    return jcfg, cfg, params


def _hist(cfg, n=N_HIST, seed=1):
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, cfg.n_items, size=(n, cfg.max_len)).astype(np.int32)
    hist[-1, :10] = 0  # a front-padded history
    return hist


def _last_states(jcfg, jp, hist):
    from repro.models import bert4rec as jax_b4r

    fwd = jax_sasrec.forward if jcfg.causal else jax_b4r.forward
    return np.asarray(fwd(jp, jcfg, jnp.asarray(hist)))[:, -1]


def _assert_topk(got, want, dense, k):
    """``got`` against the reference's ``want`` (values, ids), with the
    f64 ``dense`` scores (masked to -inf) giving the gaps."""
    gv, gi = (a.numpy() for a in got)
    wv, wi = (np.asarray(a) for a in want)
    assert gi.dtype == np.int32 and gi.shape == wi.shape
    top = -np.sort(-dense, axis=1)[:, : k + 1]
    if top.shape[1] == k:
        top = np.concatenate([top, np.full_like(top[:, :1], -np.inf)], 1)
    tol = 1e-5 * np.abs(top[:, 0]).max()
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol)
    prv = np.concatenate([np.full_like(top[:, :1], np.inf), top[:, :k - 1]],
                         1)
    isolated = ((prv - top[:, :k]) > tol) & ((top[:, :k] - top[:, 1:]) > tol)
    assert isolated.any()
    np.testing.assert_array_equal(gi[isolated], wi[isolated])
    # Exactly tied entries (copied rows or repeated candidates score the
    # same bits): the lower id / position first, as lax.top_k.
    ties = gv[:, :-1] == gv[:, 1:]
    assert (gi[:, :-1][ties] < gi[:, 1:][ties]).all()
    return gi, ties


def test_mips_serve_step_matches_jax():
    """BERT4Rec's branch (``tests/test_torch_serve.py`` holds SASRec's)."""
    arch_name = "bert4rec"
    jcfg, cfg, params = _setup(arch_name)
    hist = _hist(cfg)
    k = 7
    jstep = jax_steps.make_seqrec_mips_serve_step(
        jax_get_arch(arch_name), jcfg, None, top_k=k)
    jp = jax.tree.map(jnp.asarray, params)
    want = jstep(jp, jnp.asarray(hist))
    got = steps.make_seqrec_mips_serve_step(cfg, top_k=k)(
        sasrec_params_from_jax(params, device="cpu"), torch.from_numpy(hist))
    y = params["item_emb"][: jcfg.catalog_loss_size].astype(np.float64)
    dense = _last_states(jcfg, jp, hist).astype(np.float64) @ y.T
    dense[:, 0] = -np.inf
    dense[:, jcfg.n_items:] = -np.inf
    gi, _ = _assert_topk(got, want, dense, k)
    assert ((gi >= 1) & (gi < cfg.n_items)).all()


@pytest.mark.parametrize("arch_name", ARCHS)
def test_serve_step_top100_matches_jax(arch_name):
    """Top-100 over the catalog, phantom rows masked and row 0 allowed
    (the reference masks only ``>= n_items``), ties to the lower id."""
    jcfg, cfg, params = _setup(arch_name)
    hist = _hist(cfg)
    jstep = jax_steps.make_seqrec_serve_step(jax_get_arch(arch_name), jcfg,
                                             None)
    jp = jax.tree.map(jnp.asarray, params)
    want = jstep(jp, jnp.asarray(hist))
    got = steps.make_seqrec_serve_step(cfg)(
        sasrec_params_from_jax(params, device="cpu"), torch.from_numpy(hist))
    y = params["item_emb"][: jcfg.catalog_loss_size].astype(np.float64)
    dense = _last_states(jcfg, jp, hist).astype(np.float64) @ y.T
    dense[:, jcfg.n_items:] = -np.inf
    gi, ties = _assert_topk(got, want, dense, 100)
    assert gi.shape == (N_HIST, 100) and (gi < cfg.n_items).all()
    assert (gi == 0).any(), "row 0 never reached a top-100"
    assert ties.any(), "no copied row reached a top-100"


@pytest.mark.parametrize("arch_name", ARCHS)
def test_retrieval_step_matches_jax(arch_name):
    """One state against a candidate list with repeated ids: positions
    come back, a repeated candidate's earlier position first."""
    jcfg, cfg, params = _setup(arch_name)
    hist = _hist(cfg, n=1)
    rng = np.random.default_rng(3)
    cand = rng.integers(0, jcfg.n_items, size=300).astype(np.int32)
    cand[200:260] = cand[:60]  # repeats: exact ties at two positions
    k = 40
    jstep = jax_steps.make_seqrec_retrieval_step(jax_get_arch(arch_name),
                                                 jcfg, None, top_k=k)
    jp = jax.tree.map(jnp.asarray, params)
    want = jstep(jp, jnp.asarray(hist), jnp.asarray(cand))
    got = steps.make_seqrec_retrieval_step(cfg, top_k=k)(
        sasrec_params_from_jax(params, device="cpu"), torch.from_numpy(hist),
        torch.from_numpy(cand))
    dense = (_last_states(jcfg, jp, hist).astype(np.float64)
             @ params["item_emb"][cand].astype(np.float64).T)
    gi, ties = _assert_topk(got, want, dense, k)
    assert gi.max() < cand.size and ties.any()


def test_serve_steps_refuse_a_mesh_and_bad_candidates():
    """A rank outside the mesh is refused; on a (1, 1) mesh each step is
    its one-device self bit for bit (meshes of several ranks:
    ``tests/test_torch_dist_infer.py``); bad candidates are refused."""
    from repro_torch.dist.sharding import Mesh, make_mesh
    from repro_torch.models import bert4rec

    cfg = get_arch("bert4rec").make_smoke_config()
    params = bert4rec.init_params(cfg, seed=0, device="cpu")
    hist = torch.from_numpy(_hist(cfg, n=4))
    cand = torch.arange(3, 90, dtype=torch.int32)
    outside = Mesh({"data": 1, "model": 1}, None,
                   {"data": None, "model": None})
    for make, args in ((steps.make_seqrec_mips_serve_step, (hist,)),
                       (steps.make_seqrec_serve_step, (hist,)),
                       (steps.make_seqrec_retrieval_step, (hist, cand))):
        with pytest.raises(ValueError, match="outside"):
            make(cfg, mesh=outside)
        for a, b in zip(make(cfg, mesh=make_mesh((1, 1)))(params, *args),
                        make(cfg)(params, *args)):
            assert torch.equal(a, b)
    step = steps.make_seqrec_retrieval_step(cfg, top_k=5)
    hist = torch.from_numpy(_hist(cfg, n=1))
    for bad in ([0, cfg.catalog_loss_size], [-1, 3]):
        with pytest.raises(ValueError, match="outside the catalog"):
            step(params, hist, torch.tensor(bad, dtype=torch.int32))


def test_bert4rec_server_answers_as_its_serve_step():
    cfg = get_arch("bert4rec").make_smoke_config()
    hist = _hist(cfg, n=11, seed=4)
    with RetrievalServer("bert4rec", buckets=(4, 8), top_k=5, seed=3,
                         device="cpu") as srv:
        assert srv.cfg == cfg and not srv.cfg.causal
        assert srv.params["item_emb"].shape[0] == cfg.n_rows  # [MASK] row
        reqs = [srv.submit(h) for h in hist]
        results = [r.result(timeout=60.0) for r in reqs]
        bulk_v, bulk_i = srv.score(hist)
        health = srv.health()
        want_v, want_i = steps.make_seqrec_mips_serve_step(cfg, top_k=5)(
            srv.params, torch.from_numpy(hist))
    assert health["cache_misses"] == 0 and health["compile_count"] == 2
    np.testing.assert_array_equal(bulk_i, want_i.numpy())
    np.testing.assert_allclose(bulk_v, want_v.numpy(), rtol=0, atol=1e-6)
    for r, wi in zip(results, want_i.numpy()):
        assert not r.degraded and r.k == 5
        np.testing.assert_array_equal(r.ids, wi)


# ---------------------------------------------------------------------------
# The bitonic merge
# ---------------------------------------------------------------------------
def _merge_inputs(seed, rows, k, t, levels, n_pad):
    """A running buffer from a real merge (so it holds the invariants)
    and an integer-valued tile with ties; ``n_pad`` of its columns masked
    to NEG_INF. Buffers start starved when the first tile is short."""
    rng = np.random.default_rng(seed)

    def tile(lo, width):
        v = rng.integers(0, levels, size=(rows, width)).astype(np.float32)
        ids = np.broadcast_to(np.arange(lo, lo + width, dtype=np.int32),
                              (rows, width)).copy()
        return v, ids

    v0, i0 = tile(0, max(1, k // 2))
    vals = np.full((rows, k), NEG_INF, np.float32)
    ids = np.full((rows, k), ID_PAD, np.int32)
    vals, ids = (a.numpy() for a in merge_topk_tile(
        torch.from_numpy(vals), torch.from_numpy(ids), torch.from_numpy(v0),
        torch.from_numpy(i0), k))
    tv, ti = tile(1000, t)
    if n_pad:
        tv[:, rng.choice(t, size=min(n_pad, t), replace=False)] = NEG_INF
    return vals, ids, tv, ti


_jax_bitonic = jax.jit(jax_merge.merge_topk_tile_bitonic, static_argnums=4)


@hypothesis.settings(max_examples=6, deadline=None, database=None)
@hypothesis.given(seed=st.integers(0, 10_000), k=st.integers(1, 24),
                  t=st.integers(1, 40), levels=st.integers(1, 6),
                  n_pad=st.integers(0, 12))
def test_bitonic_merge_equals_jax_and_the_round_merge(seed, k, t, levels,
                                                      n_pad):
    vals, ids, tv, ti = _merge_inputs(seed, 5, k, t, levels, n_pad)
    args = [torch.from_numpy(a) for a in (vals, ids, tv, ti)]
    got = merge_topk_tile_bitonic(*args, k)
    rounds = merge_topk_tile(*args, k)
    want = _jax_bitonic(*(jnp.asarray(a) for a in (vals, ids, tv, ti)), k)
    for g, r, w in zip(got, rounds, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, r)
    assert got[1].dtype == torch.int32


def test_merge_impl_is_validated_and_picks_the_plain_merge(monkeypatch):
    q = torch.randint(-2, 3, (6, 8)).float()
    y = torch.randint(-2, 3, (1_300, 8)).float()  # integer ties
    valid = torch.arange(1_300) % 7 != 3
    want = ops.mips_topk(q, y, 37, valid=valid, id_offset=5)
    seen = []
    real = merge_topk_tile_bitonic

    def recording(*a):
        seen.append(a[0].shape)
        return real(*a)

    from repro_torch.kernels import topk_merge

    monkeypatch.setitem(topk_merge.MERGES, "bitonic", recording)
    got = ops.mips_topk(q, y, 37, valid=valid, id_offset=5,
                        merge_impl="bitonic")
    assert len(seen) == -(-1_300 // 512)  # one merge a streamed tile
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert merge_fn("rounds") is merge_topk_tile
    for bad in ("sort", "Bitonic", ""):
        with pytest.raises(ValueError, match="merge_impl"):
            ops.mips_topk(q, y, 5, merge_impl=bad)
        with pytest.raises(ValueError, match="merge_impl"):
            ref.mips_topk_ref(q, y, 5, merge_impl=bad)
