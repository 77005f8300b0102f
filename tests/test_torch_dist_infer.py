"""The port's distributed inference against the JAX package's single-device
results.

One module fixture starts two worlds of ``gloo`` processes
(``tests/_dist_workers.py``, task ``infer``; 2 ranks for the (1, 2) and
(2, 1) meshes, 4 for (2, 2) and (1, 4)) and every test reads what their
ranks wrote. On each mesh every rank passes the same global inputs and
must return the same, whole answer:

* the sharded sweep (``eval/harness.py::_rank_topk_sharded``) over a
  9-row batch (the data axes pad it) and a 64-row table with phantom rows
  and rows tied across shards, at k 5, and with the LSE and a softcap at
  k 1, against the reference's ``streaming_eval_scores`` at
  ``impl="ref"``: values and target scores within ``1e-5·max|score|``,
  ids equal where neighbouring scores are further apart, exact ties lower
  id first, ranks inside the dense f64 band (ROADMAP queue 3: the
  reference's ``gt``/``eq`` are no bitwise oracle), the LSE within
  ``1e-5`` relative;
* ``evaluate_streaming(mesh=)`` (SASRec) and ``evaluate_streaming_lm(mesh=)``
  (gemma-2's smoke config with a 1,000-token vocabulary: phantom rows)
  against the reference's ``mesh=None`` metrics, as
  ``tests/test_torch_eval.py`` and ``tests/test_torch_lm.py`` hold the
  one-device port;
* the three serve steps and ``RetrievalServer(mesh=)`` against the
  reference's ``mesh=None`` steps under the rules of
  ``tests/test_torch_serve_steps.py``, and a retrieval case whose tied
  candidates sit on different shards in the reverse of their position
  order (the earlier position must still come first);
* ``distributed_topk`` against ``lax.top_k`` on the concatenated
  integer-valued scores (ties everywhere), and
  ``all_to_all_bucket_shuffle``'s values, gradient and payload log.

The sharded paths are held against the reference's single-device path,
which its own sharded tests claim to equal (ROADMAP queue 3).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.eval import harness as jax_harness
from repro.eval import streaming as jax_streaming
from repro.launch import steps as jax_steps
from repro.models import sasrec as jax_sasrec
from repro.models import transformer as jtf
from repro_torch.configs import get_arch
from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
from repro_torch.dist.sharding import Mesh
from repro_torch.launch.serve import RetrievalServer
from repro_torch.models.convert import (sasrec_params_from_jax,
                                        transformer_params_from_jax)
from _dist_workers import flatten_tree
from _rank_band import f64_band
from test_torch_distributed_sce import _start, _wait
from test_torch_eval import KS, _ambiguity, _assert_metrics_close
from test_torch_lm import SEQ, _configs, _np_tree
from test_torch_serve_steps import _assert_topk, _hist, _last_states, _setup

WORLDS = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}
MESHES = [m for ms in WORLDS.values() for m in ms]
TAGS = [f"{d}x{m}" for d, m in MESHES]
LM_VOCAB = 1000
SWEEPS = {"sweep": (5, 60, None), "sweep_lm": (1, 57, 30.0)}  # k, c_hi, cap
SERVE_K = {"mips": 7, "serve": 100, "retrieval": 100, "retrieval_ties": 100}


def _sweep_inputs():
    rng = np.random.default_rng(11)
    out = {}
    for name, scale in (("sweep", 1.0), ("sweep_lm", 3.0)):
        _, hi, _ = SWEEPS[name]
        y = rng.standard_normal((64, 16)).astype(np.float32)
        y[40:44] = y[1:5]  # exact ties across shards (of 16 and of 32)
        t = rng.integers(1, hi, 9).astype(np.int32)
        t[0] = 41  # a target tied with another shard's row
        out[f"{name}_x"] = (rng.standard_normal((9, 16)) * scale).astype(
            np.float32)
        out[f"{name}_y"], out[f"{name}_t"] = y, t
        out[f"{name}_hi"] = np.array(hi)
    return out


@pytest.fixture(scope="module")
def setup():
    """Every input, in the numpy form both packages take, with the JAX
    parameters and the port's copies of them."""
    inputs = _sweep_inputs()
    # SASRec's leave-one-out evaluation
    jcfg = jax_get_arch("sasrec-sce").make_smoke_config()
    jp = jax_sasrec.init_params(jax.random.PRNGKey(3), jcfg)
    sas_p = sasrec_params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    batch, _ = SequenceDataset(SeqDataConfig(
        n_items=jcfg.n_items, seq_len=jcfg.max_len, batch_size=24,
    )).eval_batch(Cursor(seed=7))
    inputs.update(flatten_tree(sas_p, "sas"), eval_tokens=batch["tokens"])
    # gemma-2's token rank, with phantom vocabulary rows
    _, ljcfg, _, lcfg = _configs(LM_VOCAB)
    assert lcfg.vocab_padded % 4 == 0
    ljp = jtf.init_params(jax.random.PRNGKey(2), ljcfg)
    lm_p = transformer_params_from_jax(_np_tree(ljp), device="cpu")
    lbatch, _ = SequenceDataset(SeqDataConfig(
        n_items=LM_VOCAB, seq_len=SEQ, batch_size=3, min_len_frac=0.5,
    )).heldout_batch(Cursor(seed=0))
    inputs.update(flatten_tree(lm_p, "lm"), lm_vocab=np.array(LM_VOCAB),
                  **{f"lm_eval_{k}": v for k, v in lbatch.items()})
    # BERT4Rec's serve steps, with tied catalog rows (rows 250-329 copy
    # rows 1-80: item 299 and item 50 score the same bits)
    bjcfg, bcfg, bparams = _setup("bert4rec")
    b4r_p = sasrec_params_from_jax(bparams, device="cpu")
    hist = _hist(bcfg, n=8)
    rng = np.random.default_rng(5)
    cand = rng.permutation(bcfg.catalog_loss_size)[:40].astype(np.int32)
    # position 0 holds item 299 (shard 2 of 4), position 7 its twin 50
    # (shard 0): the earlier position must come first
    ties = rng.permutation(np.arange(100, 240))[:30].astype(np.int32)
    ties[0], ties[7] = 299, 50
    inputs.update(flatten_tree(b4r_p, "b4r"), hist=hist, cand=cand,
                  cand_ties=ties,
                  **{f"{k}_k": np.array(v) for k, v in SERVE_K.items()})
    # distributed_topk and the shuffle
    inputs.update(
        topk_scores=rng.integers(-2, 3, (6, 32)).astype(np.float32),
        topk_k=np.array(9),
        shuffle_x=rng.standard_normal((8, 3)).astype(np.float32),
        shuffle_w=np.array([1.0, 2.0, 3.0, 4.0], np.float32))
    return {"inputs": inputs, "sas": (jcfg, jp, sas_p, batch),
            "lm": (ljcfg, ljp, lbatch), "b4r": (bjcfg, bcfg, bparams)}


@pytest.fixture(scope="module")
def outputs(setup, tmp_path_factory):
    launches = []
    for world, meshes in WORLDS.items():
        spec = {"tasks": ["infer"], "meshes": meshes}
        launches.append(_start(tmp_path_factory.mktemp(f"infer{world}"),
                               world, spec, setup["inputs"]))
    out = {}
    for (world, meshes), ranks in zip(WORLDS.items(), _wait(launches)):
        for d, m in meshes:
            out[f"{d}x{m}"] = ranks[:d * m]  # every rank of the mesh
    return out


_REFERENCE = {}


def _reference(key, fn):
    """The reference's result for ``key``, computed once for every mesh."""
    if key not in _REFERENCE:
        _REFERENCE[key] = fn()
    return _REFERENCE[key]


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


@pytest.mark.parametrize("name", SWEEPS)
@pytest.mark.parametrize("tag", TAGS)
def test_sharded_sweep_matches_reference(setup, outputs, tag, name):
    k, hi, cap = SWEEPS[name]
    inp = setup["inputs"]
    x, y, t = (inp[f"{name}_{v}"] for v in ("x", "y", "t"))
    want = _reference(name, lambda: jax_streaming.streaming_eval_scores(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), k, block_c=16,
        c_lo=1, c_hi=hi, impl="ref", with_lse=cap is not None,
        logit_softcap=cap))
    got = {w: _same_on_every_rank(outputs[tag], f"{tag}_{name}_{w}")
           for w in ("vals", "ids", "gt", "eq", "tgt")
           + (("lse",) if cap is not None else ())}
    s = x.astype(np.float64) @ y.astype(np.float64).T
    dense = np.where((np.arange(64) >= 1) & (np.arange(64) < hi), s, -np.inf)
    tol = 1e-5 * np.abs(s).max()
    np.testing.assert_allclose(got["tgt"], np.asarray(want[4]), atol=tol)
    if k > 1:
        _assert_topk((torch.from_numpy(got["vals"]),
                      torch.from_numpy(got["ids"])), want[:2], dense, k)
    else:
        np.testing.assert_allclose(got["vals"], np.asarray(want[0]),
                                   atol=tol)
    lo, hi_rank = f64_band(x, y, t, 1, hi, 0, tol)
    rank = got["gt"] + np.maximum(got["eq"] - 1, 0)
    assert ((rank >= lo) & (rank <= hi_rank)).all()
    assert (got["eq"] >= 1).all()
    if cap is not None:
        lse = np.asarray(want[5]) + np.log(np.asarray(want[6]))
        np.testing.assert_allclose(got["lse"], lse, rtol=1e-5)


@pytest.mark.parametrize("tag", TAGS)
def test_evaluate_streaming_on_a_mesh_matches_reference(setup, outputs, tag):
    jcfg, jp, sas_p, batch = setup["sas"]
    cfg = get_arch("sasrec-sce").make_smoke_config()
    keys = _same_on_every_rank(outputs[tag], f"{tag}_eval_keys")
    vals = _same_on_every_rank(outputs[tag], f"{tag}_eval_vals")
    got = dict(zip(keys.tolist(), vals.tolist()))
    want = _reference("eval", lambda: jax_harness.evaluate_streaming(
        jp, jcfg, batch, ks=KS, block_c=128, impl="ref"))
    n_amb, cov_amb, n = _reference(
        "ambiguity", lambda: _ambiguity(cfg, sas_p, batch))
    _assert_metrics_close(got, want, n_amb, cov_amb, n, cfg.n_items)


@pytest.mark.parametrize("tag", TAGS)
def test_evaluate_streaming_lm_on_a_mesh_matches_reference(setup, outputs,
                                                           tag):
    jcfg, jp, batch = setup["lm"]
    keys = _same_on_every_rank(outputs[tag], f"{tag}_eval_lm_keys")
    vals = _same_on_every_rank(outputs[tag], f"{tag}_eval_lm_vals")
    got = dict(zip(keys.tolist(), vals.tolist()))
    want = _reference("eval_lm", lambda: jax_harness.evaluate_streaming_lm(
        jp, jcfg, batch, impl="ref"))
    assert set(got) == set(want)
    for key in want:
        rel = 1e-5 if key == "loss" else 1e-12
        assert got[key] == pytest.approx(want[key], rel=rel), key


def _b4r_want(setup, name):
    """The reference's mesh=None step on the same weights, and its dense
    f64 scores (masked as the step masks)."""
    jcfg, cfg, params = setup["b4r"]
    inp = setup["inputs"]
    arch = jax_get_arch("bert4rec")
    k = SERVE_K[name]
    jp = jax.tree.map(jnp.asarray, params)
    hist = inp["hist"]
    if name.startswith("retrieval"):
        cand = inp["cand" if name == "retrieval" else "cand_ties"]
        n_q = 2 if name == "retrieval" else 1
        want = jax_steps.make_seqrec_retrieval_step(arch, jcfg, None,
                                                    top_k=min(k, cand.size))(
            jp, jnp.asarray(hist[:n_q]), jnp.asarray(cand))
        dense = (_last_states(jcfg, jp, hist[:n_q]).astype(np.float64)
                 @ params["item_emb"][cand].astype(np.float64).T)
        return want, dense, min(k, cand.size)
    make = (jax_steps.make_seqrec_mips_serve_step if name == "mips"
            else jax_steps.make_seqrec_serve_step)
    want = make(arch, jcfg, None, top_k=k)(jp, jnp.asarray(hist))
    dense = (_last_states(jcfg, jp, hist).astype(np.float64)
             @ params["item_emb"][:jcfg.catalog_loss_size]
             .astype(np.float64).T)
    ids = np.arange(dense.shape[1])
    lo = 1 if name == "mips" else 0
    dense[:, (ids < lo) | (ids >= jcfg.n_items)] = -np.inf
    return want, dense, k


@pytest.mark.parametrize("name", list(SERVE_K))
@pytest.mark.parametrize("tag", TAGS)
def test_serve_steps_on_a_mesh_match_reference(setup, outputs, tag, name):
    want, dense, k = _reference(name, lambda: _b4r_want(setup, name))
    got = tuple(torch.from_numpy(_same_on_every_rank(
        outputs[tag], f"{tag}_{name}_{w}")) for w in ("vals", "ids"))
    gi, ties = _assert_topk(got, want, dense, k)
    if name == "retrieval_ties":
        # the twins tie exactly; the earlier position (0, on the later
        # shard) comes first
        row = gi[0].tolist()
        assert row.index(0) < row.index(7)


@pytest.mark.parametrize("tag", TAGS)
def test_server_on_a_mesh_matches_reference_step(setup, outputs, tag):
    ranks = outputs[tag]
    assert all(bool(r[f"{tag}_server_ready"]) for r in ranks)
    want, dense, _ = _reference("mips", lambda: _b4r_want(setup, "mips"))
    want, dense = tuple(np.asarray(a)[:5] for a in want), dense[:5]
    got = tuple(torch.from_numpy(_same_on_every_rank(
        ranks, f"{tag}_server_{w}")) for w in ("vals", "ids"))
    _assert_topk(got, want, dense, 7)


def test_server_refuses_buckets_that_do_not_divide_the_data_axes():
    wide = Mesh({"data": 2, "model": 1}, {"data": 0, "model": 0},
                {"data": None, "model": None})
    with pytest.raises(ValueError, match=r"buckets \[5\] do not divide"):
        RetrievalServer("bert4rec", buckets=(4, 5), device="cpu", mesh=wide,
                        defer_readiness=True)
    outside = Mesh({"data": 1, "model": 1}, None,
                   {"data": None, "model": None})
    with pytest.raises(ValueError, match="outside"):
        RetrievalServer("bert4rec", device="cpu", mesh=outside,
                        defer_readiness=True)


@pytest.mark.parametrize("tag", TAGS)
def test_distributed_topk_tie_order_matches_lax_top_k(setup, outputs, tag):
    inp = setup["inputs"]
    k = int(inp["topk_k"])
    vals, idx = jax.lax.top_k(jnp.asarray(inp["topk_scores"]), k)
    m = MESHES[TAGS.index(tag)][1]
    got = {w: _same_on_every_rank(outputs[tag], f"{tag}_dtopk_{w}")
           for w in ("vals", "ids", "src")}
    np.testing.assert_array_equal(got["vals"], np.asarray(vals))
    np.testing.assert_array_equal(got["ids"], np.asarray(idx))
    np.testing.assert_array_equal(got["src"], np.asarray(idx) // (32 // m))


@pytest.mark.parametrize("tag", TAGS)
def test_all_to_all_bucket_shuffle_values_gradient_and_log(setup, outputs,
                                                           tag):
    """Rank ``r``'s payload is ``x + 100·r``; out[i] on model shard ``j``
    is shard ``i``'s bucket block ``j``; with the loss ``Σ w[i]·out[i]``
    on every shard, every block of shard ``j``'s payload lands at slot
    ``j`` somewhere, so its gradient is ``w[j]`` throughout (the inverse
    all-to-all carries it home)."""
    inp = setup["inputs"]
    x, w = inp["shuffle_x"], inp["shuffle_w"]
    d, m = MESHES[TAGS.index(tag)]
    per = x.shape[0] // m
    for rank, r in enumerate(outputs[tag]):
        line = [rank - r[f"{tag}_coords"][1] + i for i in range(m)]
        j = int(r[f"{tag}_coords"][1])
        want = np.stack([x[j * per:(j + 1) * per]
                         + np.float32(100.0 * line[i]) for i in range(m)])
        np.testing.assert_array_equal(r[f"{tag}_shuffle_out"], want)
        np.testing.assert_array_equal(
            r[f"{tag}_shuffle_grad"],
            np.broadcast_to(w[j], x.shape).astype(np.float32))
        (rec,) = json.loads(str(r[f"{tag}_shuffle_log"]))
        assert rec["op"] == "all-to-all" and rec["axis"] == "model"
        assert tuple(rec["shape"]) == (m, per, 3)
        assert rec["payload_bytes"] == x.size * 4
        assert rec["wire_bytes"] == x.size * 4 * (m - 1) / m
