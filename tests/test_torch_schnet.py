"""The port's SchNet, its graph data and its train step against the JAX
package's, at the smoke config (and the published RBF centres) on the CPU.

JAX parameters (``repro.models.schnet.init_params``, biases made
non-zero) go through ``schnet_params_from_jax``; both sides take the
same numpy graphs: batched molecules, a padded full graph (nodes and
edges padded to multiples of 16, ``edge_valid`` / ``node_valid`` masking
the padding, as the reference's full-graph cells pad to 512) and a
neighbour-sampled subgraph whose features, positions and targets are
gathered by ``node_ids``. Tolerances (f32 fold order and the scatter-add's
order): energies and embeddings within ``1e-5·max|x|`` (plus ``rtol
1e-5``), losses and grad norms within ``1e-5`` relative, params after one
AdamW step within ``1e-5·max|p|`` but where the reference's gradient is
below ``1e-5·max|g|`` (within ``2·lr``). The graph generators, the
sampler, and the RBF centres and width are bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.common import ShapeSpec as JaxShapeSpec
from repro.data import Cursor as JaxCursor
from repro.data import GraphDataConfig as JaxGraphDataConfig
from repro.data import NeighborSampler as JaxNeighborSampler
from repro.data import batched_molecules as jax_batched_molecules
from repro.data import random_graph as jax_random_graph
from repro.launch import steps as jax_steps
from repro.models import schnet as jax_schnet
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import (Cursor, GraphDataConfig, NeighborSampler,
                              batched_molecules, random_graph)
from repro_torch.launch import steps
from repro_torch.launch.train import to_device, train
from repro_torch.models import schnet
from repro_torch.models.convert import schnet_params_from_jax
from repro_torch.optim.optimizers import tree_leaves

LR = 1e-3
B1 = 0.9  # AdamW's: the first step's m is (1 − b1)·g
KINDS = ("molecule", "full_graph_sm", "minibatch_lg")
N_MOLS = 4


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_arch("schnet").make_smoke_config()
    cfg = get_arch("schnet").make_smoke_config()
    # the port's init in the reference's layout (checked in the converter
    # test): compiling the reference's init would cost seconds a run
    jp = jax.tree.map(lambda t: t.numpy().copy(),
                      schnet.init_params(cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(1)
    for tree in (jp, jp["interactions"]):
        for k in tree:
            if k.startswith("b") or k.startswith("head_b"):
                tree[k] = rng.normal(scale=0.1, size=tree[k].shape).astype(
                    np.float32)
    return jcfg, cfg, jp, schnet_params_from_jax(jp, device="cpu")


def _graph(kind, d_feat, seed=0):
    """``(batch, shape dims)`` of one regime as numpy arrays."""
    if kind == "molecule":
        b, _ = batched_molecules(Cursor(seed=seed), n_mols=N_MOLS,
                                 nodes_per_mol=6, edges_per_mol=10,
                                 d_feat=d_feat)
        b.pop("n_graphs")
        return b, {"batch": N_MOLS, "n_nodes": 6, "n_edges": 10,
                   "d_feat": d_feat}
    g = random_graph(GraphDataConfig(n_nodes=40, n_edges=50, d_feat=d_feat,
                                     seed=seed))
    if kind == "full_graph_sm":
        n, e = 40, g["edge_index"].shape[1]
        n_pad, e_pad = -(-n // 16) * 16, -(-e // 16) * 16
        return {
            "node_feats": np.pad(g["node_feats"], ((0, n_pad - n), (0, 0))),
            "positions": np.pad(g["positions"], ((0, n_pad - n), (0, 0))),
            "edge_index": np.pad(g["edge_index"], ((0, 0), (0, e_pad - e))),
            "edge_valid": np.arange(e_pad) < e,
            "node_valid": np.arange(n_pad) < n,
            "targets": np.pad(g["targets"], (0, n_pad - n)),
        }, {"n_nodes": n, "n_edges": e, "d_feat": d_feat}
    s, _ = NeighborSampler(g["edge_index"], 40).sample(
        Cursor(seed=seed), batch_nodes=4, fanouts=(3, 2))
    ids = s["node_ids"]
    return {
        "node_feats": g["node_feats"][ids],
        "positions": g["positions"][ids],
        "edge_index": s["edge_index"],
        "edge_valid": s["edge_valid"],
        "seed_local": s["seed_local"],
        "targets": g["targets"][ids[s["seed_local"]]],
    }, {"n_nodes": 40, "n_edges": 50, "batch_nodes": 4, "fanout0": 3,
        "fanout1": 2, "d_feat": d_feat}


def test_graph_data_bit_for_bit():
    """``random_graph``, ``NeighborSampler.sample`` (two steps) and
    ``batched_molecules`` equal the reference's, values and dtypes."""
    kw = dict(n_nodes=30, n_edges=70, d_feat=5, seed=3)
    mine, ref = random_graph(GraphDataConfig(**kw)), \
        jax_random_graph(JaxGraphDataConfig(**kw))
    pairs = [(mine, ref)]
    ms, rs = NeighborSampler(mine["edge_index"], 30), \
        JaxNeighborSampler(ref["edge_index"], 30)
    for step in (0, 1):
        pairs.append((ms.sample(Cursor(seed=4, step=step), 5, (3, 2))[0],
                      rs.sample(JaxCursor(seed=4, step=step), 5, (3, 2))[0]))
    pairs.append((
        batched_molecules(Cursor(seed=5), n_mols=3, nodes_per_mol=7,
                          edges_per_mol=9, d_feat=4)[0],
        jax_batched_molecules(JaxCursor(seed=5), n_mols=3, nodes_per_mol=7,
                              edges_per_mol=9, d_feat=4)[0]))
    for got, want in pairs:
        assert set(got) == set(want)
        for k in want:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which", ["smoke", "published"])
def test_rbf_centers_bit_for_bit(which):
    """The centres and gamma equal the reference's ``jnp.linspace`` and
    ``1 / (c₁ − c₀)²`` bit for bit (γ ≈ 894 at the published config), and
    the expansion agrees within f32's exp."""
    cfg = (get_arch("schnet").make_smoke_config() if which == "smoke"
           else get_arch("schnet").make_config("molecule"))

    def ref():  # rbf_expand's two lines
        c = jnp.linspace(0.0, cfg.cutoff, cfg.n_rbf, dtype=jnp.float32)
        return c, 1.0 / (c[1] - c[0]) ** 2

    got_c, got_g = schnet.rbf_centers(cfg)
    assert got_c.dtype == torch.float32 and got_g.dtype == torch.float32
    for want_c, want_g in (ref(), jax.jit(ref)()):  # eager and compiled
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    dist = np.random.default_rng(2).random(64).astype(np.float32) * 12
    _close(schnet.rbf_expand(torch.from_numpy(dist), cfg).numpy(),
           np.asarray(jax_schnet.rbf_expand(jnp.asarray(dist), cfg)))
    _close(schnet.cosine_cutoff(torch.from_numpy(dist), cfg.cutoff).numpy(),
           np.asarray(jax_schnet.cosine_cutoff(jnp.asarray(dist),
                                               cfg.cutoff)))


def test_shifted_softplus_matches_jax():
    """``logaddexp(x, 0) − log 2`` (not ``F.softplus``, which returns x
    itself above 20), across the threshold."""
    x = np.array([-80, -20, -1, 0, 0.5, 19.9, 20.1, 25, 40, 90],
                 np.float32)
    _close(schnet.shifted_softplus(torch.from_numpy(x)).numpy(),
           np.asarray(jax_schnet.shifted_softplus(jnp.asarray(x))))


def test_converter_copies_every_leaf(model):
    """The reference's init's tree and shapes (traced, not compiled) are
    the port's; the converter copies such a tree leaf for leaf."""
    jcfg, cfg, jp, tp = model
    ref = jax.eval_shape(lambda k: jax_schnet.init_params(k, jcfg),
                         jax.random.PRNGKey(0))
    assert jax.tree.structure(ref) == jax.tree.structure(jp)
    assert [a.shape for a in jax.tree.leaves(ref)] == \
        [w.shape for w in jax.tree.leaves(jp)]
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(KeyError):
        schnet_params_from_jax({k: v for k, v in jp.items()
                                if k != "head_b2"}, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_energies_match_jax(model, kind):
    """``node_energies`` (with ``edge_valid`` where the regime pads) and,
    on molecules, ``forward``'s per-graph energies against the
    reference's."""
    jcfg, cfg, jp, tp = model
    b, _ = _graph(kind, cfg.d_feat, seed=6)
    t = to_device(b, "cpu")
    ev = b.get("edge_valid")
    we, wx = jax.jit(jax_schnet.node_energies, static_argnums=1)(
        jp, jcfg, b["node_feats"], b["positions"], b["edge_index"],
        None if ev is None else jnp.asarray(ev))
    jfwd = jax.jit(jax_schnet.forward, static_argnums=(1, 6))
    ge, gx = schnet.node_energies(tp, cfg, t["node_feats"], t["positions"],
                                  t["edge_index"], t.get("edge_valid"))
    _close(ge.numpy(), np.asarray(we))
    _close(gx.numpy(), np.asarray(wx))
    if kind == "molecule":
        want, _ = jfwd(jp, jcfg, b["node_feats"], b["positions"],
                       b["edge_index"], jnp.asarray(b["graph_ids"]), N_MOLS)
        got, _ = schnet.forward(tp, cfg, t["node_feats"], t["positions"],
                                t["edge_index"], t["graph_ids"], N_MOLS)
        _close(got.numpy(), np.asarray(want))
        # one graph without graph_ids
        want, _ = jfwd(jp, jcfg, b["node_feats"], b["positions"],
                       b["edge_index"], None, 1)
        got, _ = schnet.forward(tp, cfg, t["node_feats"], t["positions"],
                                t["edge_index"])
        _close(got.numpy(), np.asarray(want))
    if ev is not None and not ev.all():  # padded edges carry nothing
        keep = torch.from_numpy(ev)
        ge2, _ = schnet.node_energies(
            tp, cfg, t["node_feats"], t["positions"],
            t["edge_index"][:, keep])
        _close(ge2.numpy(), ge.numpy())


def test_mse_loss_matches_jax(model):
    """``mse_loss`` on molecules, plain and with a ``graph_valid`` mask."""
    jcfg, cfg, jp, tp = model
    b, _ = _graph("molecule", cfg.d_feat, seed=9)
    t = to_device(b, "cpu")
    loss = jax.jit(lambda p, bt: jax_schnet.mse_loss(
        p, jcfg, {**bt, "n_graphs": N_MOLS}))
    for valid in (None, np.arange(N_MOLS) % 2 == 0):
        extra = {} if valid is None else {"graph_valid": valid}
        want = loss(jp, {**b, **extra})
        got = schnet.mse_loss(tp, cfg, {
            **t, **to_device(extra, "cpu"), "n_graphs": N_MOLS})
        assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_train_step_matches_reference(model, kind):
    """One guarded AdamW step of ``make_gnn_train_step`` against the
    reference's jitted step: each regime's loss (the seeds' energies,
    per-graph energies, masked node regression)."""
    jcfg, cfg, jp, tp = model
    b, dims = _graph(kind, cfg.d_feat, seed=7)
    jarch, arch = jax_get_arch("schnet"), get_arch("schnet")
    shape_kind = jarch.shape(kind).kind
    jstep, (jinit, _) = jax_steps.make_gnn_train_step(
        jarch, jcfg, None, JaxShapeSpec(kind, shape_kind, dims))
    jb = jax.tree.map(jnp.asarray, b)
    jparams = jax.tree.map(jnp.asarray, jp)
    jp2, js, jm = jax.jit(lambda p, bt, k: jstep(p, jinit(p), bt, k))(
        jparams, jb, jax.random.PRNGKey(0))
    m_grad = jax.tree.map(lambda m: m / (1 - B1), js.inner["m"])
    step, (init, _) = steps.make_gnn_train_step(
        arch, cfg, ShapeSpec(kind, shape_kind, dims))
    params = schnet_params_from_jax(jp, device="cpu")
    marks = []
    tp2, state, tm = step(params, init(params), to_device(b, "cpu"),
                          mark=marks.append)
    assert marks == ["forward", "backward", "optimizer"]
    assert not bool(tm["skipped"]) and not bool(jm["skipped"])
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    for got, want, g in zip(tree_leaves(tp2), jax.tree.leaves(jp2),
                            jax.tree.leaves(m_grad)):
        got, want, g = got.numpy(), np.asarray(want), np.abs(np.asarray(g))
        diff = np.abs(got - want)
        assert (diff <= 2 * LR).all()
        assert not (diff > 1e-5 * np.abs(want).max())[g >= 1e-5 * g.max()] \
            .any()


def test_permutation_invariance(model):
    """The graph energy is invariant to relabelling the nodes (the
    reference's ``test_models.py`` property, on the port)."""
    _, cfg, _, tp = model
    rng = np.random.default_rng(8)
    n, e = 10, 30
    feats = torch.from_numpy(rng.normal(size=(n, cfg.d_feat)).astype(
        np.float32))
    pos = torch.from_numpy((rng.random((n, 3)) * 4).astype(np.float32))
    ei = torch.from_numpy(rng.integers(0, n, (2, e)))
    e1, _ = schnet.forward(tp, cfg, feats, pos, ei)
    perm = torch.from_numpy(rng.permutation(n))
    inv = torch.argsort(perm)
    e2, _ = schnet.forward(tp, cfg, feats[perm], pos[perm], inv[ei])
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4)


def test_trainer_runs_and_resumes(tmp_path):
    """``train("schnet", device="cpu")``: finite losses, the molecule
    stream, a resumed run bit for bit; the refusals of the reference
    (``n_hosts``) and of the port (``grad_compression``)."""
    kw = dict(batch=4, device="cpu", log_every=0, ckpt_every=2)
    full = train("schnet", steps=4, **kw)
    part = train("schnet", steps=2, ckpt_dir=str(tmp_path), **kw)
    rest = train("schnet", steps=4, ckpt_dir=str(tmp_path), **kw)
    assert all(np.isfinite(full["losses"])) and full["skipped_steps"] == 0
    assert part["losses"] + rest["losses"] == full["losses"]
    with pytest.raises(ValueError):
        train("schnet", steps=1, batch=4, device="cpu", n_hosts=2)
    with pytest.raises(ValueError):
        train("schnet", steps=1, batch=4, device="cpu",
              grad_compression="int8")


def test_config_matches_reference():
    mine, ref = get_arch("schnet"), jax_get_arch("schnet")
    for s in ref.shapes:
        assert dataclasses.asdict(mine.make_config(s.name)) == \
            dataclasses.asdict(ref.make_config(s.name))
    assert [(s.name, s.kind, dict(s.dims)) for s in mine.shapes] == \
        [(s.name, s.kind, dict(s.dims)) for s in ref.shapes]
    assert (mine.family, mine.optimizer, mine.train_loss) == \
        (ref.family, ref.optimizer, ref.train_loss)
    assert mine.make_config().param_count() == ref.make_config().param_count()
