"""The port's LM path (``launch/steps.py::make_lm_train_step``,
``eval/harness.py::evaluate_streaming_lm``, ``launch/train.py``'s ``lm``
family, ``models/convert.py``) against the JAX package's, on the CPU.

Both sides start from the same weights (the reference's
``transformer.init_params``, carried across by
``transformer_params_from_jax``) and step the same batches
(``SequenceDataset``, ``Cursor(seed)``), at gemma-2-2b's smoke config
(vocabulary 1024) and a variant with vocabulary 1000 (8 phantom rows),
and at the MoE LMs' smoke configs (granite-moe-3b-a800m with AdamW,
kimi-k2 with a shared expert and Adafactor; SCE plus the balance loss).
SCE's Mix draw is the reference's own — ``fold_in(key, 0)`` of the
step's key, which the LM step passes to the loss whole — injected into
the port's step; dropout does not exist in either step. The reference
runs with its kernel guard off and, on the (1, 1) mesh, its plain
selection (``build_sce_config`` patched to ``use_kernel=False``: its
kernel path fails inside ``shard_map`` on jax 0.9, ROADMAP queue 3).

The same SCE step with ``dtype="bfloat16"`` on both sides (gemma-2's
and granite's published type): loss within 2e-2 relative, parameters within 2e-2 of
their norm, each tensor within that plus the reference's own update of
it (an AdamW step on a near-zero gradient moves a parameter by about lr
whatever the gradient's sign).

Tolerances: loss within ``2e-5`` and grad norm within ``1e-4`` relative
per step (f32 sums in another order through 2 layers and the loss);
metrics of the token-rank evaluation equal (no near-ties at these
seeds), its loss within ``1e-5`` relative.
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
from repro.data import SeqDataConfig as JaxSeqDataConfig
from repro.data import SequenceDataset as JaxSequenceDataset
from repro.eval import harness as jax_harness
from repro.kernels import guard
from repro.launch import steps as jax_steps
from repro.models import transformer as jtf
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset, lm_batch
from repro_torch.eval import evaluate_streaming_lm, lm_targets_and_valid
from repro_torch.launch import steps, train
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import (
    adafactor_state_from_jax,
    adamw_state_from_jax,
    transformer_params_from_jax,
)
from repro_torch.models.moe import MoEConfig
from repro_torch.optim.optimizers import tree_leaves

BATCH = 2
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ttf.TransformerConfig)}
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**{f.name: getattr(jcfg.moe, f.name)
                                 for f in dataclasses.fields(MoEConfig)})
    return ttf.TransformerConfig(**kw)


def _configs(vocab=None, arch="gemma2-2b"):
    jarch = jax_get_arch(arch)
    jcfg = jarch.make_smoke_config()
    if vocab is not None:
        jcfg = dataclasses.replace(jcfg, vocab=vocab)
    return jarch, jcfg, get_arch(arch), _port_config(jcfg)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _shapes(name):
    dims = {"global_batch": BATCH, "seq_len": SEQ}
    return (JaxShapeSpec(name, "train", dims), ShapeSpec(name, "train", dims))


def _run_both(jarch, jcfg, arch, cfg, *, n_steps, mesh=False,
              sce_mode="gspmd", shape_name="train_smoke", omega=False):
    """n_steps of both steps from the same state → per step (port loss,
    ref loss, port grad norm, ref grad norm)."""
    jshape, shape = _shapes(shape_name)
    jmesh = tmesh = None
    if mesh:
        from repro.launch.mesh import make_host_mesh as jax_host_mesh
        from repro_torch.launch.mesh import make_host_mesh
        jmesh, tmesh = jax_host_mesh(max_data=BATCH), make_host_mesh(
            max_data=BATCH)
    jstep, (jinit, _), jsce = jax_steps.make_lm_train_step(
        jarch, jcfg, jmesh, jshape, sce_mode=sce_mode)
    jstep = jax.jit(jstep)
    tstep, (tinit, _), tsce = steps.make_lm_train_step(
        arch, cfg, shape, mesh=tmesh, sce_mode=sce_mode)
    assert (tsce.n_buckets, tsce.bucket_size_x, tsce.bucket_size_y,
            tsce.logit_softcap) == (jsce.n_buckets, jsce.bucket_size_x,
                                    jsce.bucket_size_y, jsce.logit_softcap)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    js = jinit(jp)
    tp = transformer_params_from_jax(_np_tree(jp), device="cpu")
    ts = tinit(tp)
    data = SequenceDataset(SeqDataConfig(n_items=cfg.vocab, seq_len=SEQ,
                                         batch_size=BATCH, min_len_frac=1.0))
    cur = Cursor(seed=0)
    out = []
    for i in range(n_steps):
        batch, cur = data.next_batch(cur)
        key = jax.random.PRNGKey(300 + i)
        kw = {}
        if omega:
            om = jax.random.normal(jax.random.fold_in(key, 0),
                                   (jsce.n_buckets, BATCH * SEQ), jnp.float32)
            kw["omega"] = torch.from_numpy(np.array(om))
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch), key)
        tp, ts, tm = tstep(tp, ts, train.to_device(batch, "cpu"), **kw)
        assert not bool(tm["skipped"]) and not bool(jm["skipped"])
        out.append((float(tm["loss"]), float(jm["loss"]),
                    float(tm["grad_norm"]), float(jm["grad_norm"])))
    return out


def _check_steps(rows):
    for tl, jl, tg, jg in rows:
        assert tl == pytest.approx(jl, rel=2e-5)
        assert tg == pytest.approx(jg, rel=1e-4)


@pytest.mark.parametrize("vocab", [None, 1000])
def test_sce_step_on_one_by_one_mesh_matches_reference(monkeypatch, vocab):
    """The reference trainer's default LM path on one device: two steps of
    ``make_lm_train_step(..., mesh, sce_mode="exact")`` on a (1, 1) mesh,
    SCE with the final softcap 30 over the padded table (phantom rows
    included with vocabulary 1000), the Mix draw injected."""
    build = jax_steps.build_sce_config
    monkeypatch.setattr(jax_steps, "build_sce_config",
                        lambda *a, **kw: build(*a, **dict(kw,
                                                          use_kernel=False)))
    jarch, jcfg, arch, cfg = _configs(vocab)
    guard.set_policy("off")
    try:
        rows = _run_both(jarch, jcfg, arch, cfg, n_steps=2, mesh=True,
                         sce_mode="exact", omega=True)
    finally:
        guard.set_policy(None)
    _check_steps(rows)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "kimi-k2-1t-a32b"])
def test_moe_sce_step_on_one_by_one_mesh_matches_reference(monkeypatch,
                                                           arch):
    """The MoE LMs' smoke configs through two steps of the reference
    trainer's default path (``sce_mode="exact"`` on a (1, 1) mesh, the
    Mix draw injected, the reference's plain selection): SCE without a
    softcap plus the balance loss, granite's AdamW and kimi-k2's
    Adafactor (a shared expert, untied embeddings)."""
    build = jax_steps.build_sce_config
    monkeypatch.setattr(jax_steps, "build_sce_config",
                        lambda *a, **kw: build(*a, **dict(kw,
                                                          use_kernel=False)))
    jarch, jcfg, arch_, cfg = _configs(arch=arch)
    assert arch_.optimizer == jarch.optimizer
    guard.set_policy("off")
    try:
        rows = _run_both(jarch, jcfg, arch_, cfg, n_steps=2, mesh=True,
                         sce_mode="exact", omega=True)
    finally:
        guard.set_policy(None)
    _check_steps(rows)


def test_ce_fused_linear_step_with_softcap_at_two_microbatches():
    """``train_loss="ce_fused_linear"`` (the full-CE baseline, softcap 30
    inside the tile; the reference's Pallas kernel in interpret mode) at
    2 microbatches of one sequence each: the averaged loss and gradients
    step the same parameters."""
    jarch, jcfg, arch, cfg = _configs()
    jarch = dataclasses.replace(jarch, train_loss="ce_fused_linear")
    arch = dataclasses.replace(arch, train_loss="ce_fused_linear")
    guard.set_policy("off")
    try:
        rows = _run_both(jarch, jcfg, arch, cfg, n_steps=2,
                         shape_name="train_4k")
    finally:
        guard.set_policy(None)
    _check_steps(rows)


def test_in_place_update_equals_the_functional_one():
    """The trainers' guarded update, written in place, holds the very
    values the functional AdamW update returns, and keeps every leaf bit
    for bit on a step the guard skips."""
    from repro_torch.optim.optimizers import make_optimizer, tree_map

    _, _, _, cfg = _configs()
    init, update = make_optimizer("adamw", 3e-4)
    p0 = ttf.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(5)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), p0)
    loss = torch.tensor(2.0)
    pf = tree_map(torch.clone, p0)
    sf = init(pf)
    p = tree_map(torch.clone, p0)
    s = init(p)
    for _ in range(2):  # the second step sees non-zero moments
        pf, sf = update(grads, sf, pf)
        p, s, m = steps._apply_update_guarded(update, loss, grads, p, s)
        assert not bool(m["skipped"])
    leaves = tree_leaves(p) + tree_leaves(s)
    assert all(torch.equal(a, b) for a, b in
               zip(leaves, tree_leaves(pf) + tree_leaves(sf)))
    before = [t.clone() for t in leaves]
    p2, s2, m = steps._apply_update_guarded(
        update, loss, grads, p, s, loss_cap=torch.tensor(1.0))
    assert bool(m["skipped"])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(p2) + tree_leaves(s2), before))


def test_lm_and_heldout_batches_match_reference():
    """``lm_batch`` and ``heldout_batch`` are the reference's, array for
    array (the same numpy generator on the same cursor)."""
    from repro.data.sequences import lm_batch as jax_lm_batch

    got, cur = lm_batch(Cursor(seed=3), 1000, BATCH, SEQ)
    want, jcur = jax_lm_batch(JaxCursor(seed=3), 1000, BATCH, SEQ)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert got["valid"][:, :-1].all()  # full-length sequences
    assert cur.step == jcur.step


def test_converters_carry_params_and_adamw_state():
    """Dense and MoE parameters (granite's experts; kimi-k2's shared
    expert and untied table) and the arch's AdamW or Adafactor state
    carry across leaf for leaf; a tree with an unknown layer key or an
    MoE block without its router raises."""
    from repro.optim import make_optimizer
    for arch, vocab, tied in (("gemma2-2b", None, True),
                              ("gemma2-2b", 1000, False),
                              ("granite-moe-3b-a800m", None, True),
                              ("kimi-k2-1t-a32b", None, False)):
        jarch, jcfg, _, cfg = _configs(vocab, arch=arch)
        jcfg = dataclasses.replace(jcfg, tie_embeddings=tied)
        jp = jtf.init_params(jax.random.PRNGKey(1), jcfg)
        tp = transformer_params_from_jax(_np_tree(jp), device="cpu")
        assert ("unembed" in tp) == (not tied)
        assert ("moe" in tp["layers"]) == (jcfg.moe is not None)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            assert np.array_equal(a.numpy(), np.asarray(b))
        jinit, jupd = make_optimizer(jarch.optimizer, 3e-4)
        js = jinit(jp)
        grads = jax.tree.map(jnp.ones_like, jp)
        _, js = jupd(grads, js, jp)
        convert = (adamw_state_from_jax if jarch.optimizer == "adamw"
                   else adafactor_state_from_jax)
        ts = convert(_np_tree(js), device="cpu")
        assert int(ts.step) == int(js.step) == 1
        for a, b in zip(tree_leaves(ts.inner), jax.tree.leaves(js.inner)):
            assert np.array_equal(a.numpy(), np.asarray(b))
        if jcfg.moe is not None:
            bad = _np_tree(jp)
            del bad["layers"]["moe"]["router"]
            with pytest.raises(KeyError):
                transformer_params_from_jax(bad, device="cpu")
    bad = _np_tree(jtf.init_params(jax.random.PRNGKey(1),
                                   _configs()[1]))
    bad["layers"]["ffn"] = bad["layers"].pop("mlp")
    with pytest.raises(KeyError):
        transformer_params_from_jax(bad, device="cpu")


@pytest.mark.parametrize("vocab", [None, 1000])
def test_evaluate_streaming_lm_matches_reference(vocab):
    """Token rank over every next-token position of held-out sequences,
    the reference's ``evaluate_streaming_lm`` at ``impl="ref"``: the same
    metrics; the loss (``lse − softcap(tgt)``, cap 30) within 1e-5."""
    _, jcfg, _, cfg = _configs(vocab)
    jp = jtf.init_params(jax.random.PRNGKey(2), jcfg)
    tp = transformer_params_from_jax(_np_tree(jp), device="cpu")
    batch, _ = JaxSequenceDataset(JaxSeqDataConfig(
        n_items=jcfg.vocab, seq_len=SEQ, batch_size=3, min_len_frac=0.5,
    )).heldout_batch(JaxCursor(seed=0))
    tbatch, _ = SequenceDataset(SeqDataConfig(
        n_items=cfg.vocab, seq_len=SEQ, batch_size=3, min_len_frac=0.5,
    )).heldout_batch(Cursor(seed=0))
    assert all(np.array_equal(batch[k], tbatch[k]) for k in batch)
    want = jax_harness.evaluate_streaming_lm(jp, jcfg, batch, impl="ref")
    got = evaluate_streaming_lm(tp, cfg, tbatch)
    assert set(got) == set(want)
    for k in want:
        if k == "loss":
            assert got[k] == pytest.approx(want[k], rel=1e-5)
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
    # without the pipeline's targets: recomputed, the same rows
    targets, valid = lm_targets_and_valid(tbatch["tokens"])
    assert np.array_equal(targets, tbatch["targets"])
    assert np.array_equal(valid, tbatch["valid"])
    assert evaluate_streaming_lm(tp, cfg, {"tokens": tbatch["tokens"]}) == got
    # the sharded path on a (1, 1) mesh is the one-device evaluation
    from repro_torch.dist.sharding import make_mesh

    assert evaluate_streaming_lm(tp, cfg, tbatch, mesh=make_mesh((1, 1))) \
        == got


def test_trainer_lm_family_resumes_bit_for_bit(tmp_path):
    """``train("gemma2-2b", device="cpu", seq_len=…)``: falling losses
    with the token-rank evaluation, and 5 steps equal 3 steps plus a run
    resumed from their checkpoint (step 2) bit for bit."""
    kw = dict(batch=BATCH, seq_len=SEQ, seed=0, log_every=0, device="cpu")
    straight = train.train("gemma2-2b", steps=5, eval_every=5, eval_users=2,
                           **kw)
    assert straight["steps"] == 5
    assert {"hr@1", "mean_rank", "loss", "n_tokens"} <= set(straight["eval"])
    assert straight["eval"]["n_tokens"] == 2 * (SEQ - 1)
    ck = str(tmp_path / "ck")
    first = train.train("gemma2-2b", steps=3, ckpt_dir=ck, ckpt_every=3,
                        **kw)
    resumed = train.train("gemma2-2b", steps=5, ckpt_dir=ck, ckpt_every=3,
                          **kw)
    assert resumed["steps"] == 2
    assert first["losses"] + resumed["losses"] == straight["losses"]


# -- gemma-2's and granite's smoke LM steps in bf16 ----------------------------
def test_bf16_lm_sce_step_matches_reference(monkeypatch):
    """gemma-2's smoke LM step in bf16 (see :func:`_bf16_lm_sce_step`)."""
    _bf16_lm_sce_step(monkeypatch, "gemma2-2b")


def test_bf16_moe_lm_sce_step_matches_reference(monkeypatch):
    """granite's smoke LM step in bf16: its MoE FFN, the router in f32
    (see :func:`_bf16_lm_sce_step`)."""
    _bf16_lm_sce_step(monkeypatch, "granite-moe-3b-a800m")


def _bf16_lm_sce_step(monkeypatch, arch_name):
    """Two steps of ``make_lm_train_step(..., sce_mode="exact")`` on a
    (1, 1) mesh at gemma-2's (or granite's: its MoE FFN) smoke config
    with ``dtype="bfloat16"`` on
    both sides (bf16 parameters and activations into the kernels' plain
    versions; AdamW moments and the microbatch accumulator f32), from the
    same weights and batches, the reference's Mix draw injected and its
    plain selection (``use_kernel=False``, as ``test_torch_lm.py``): each
    step's loss within 2e-2 relative, the parameters after the steps
    within 2e-2 of their whole norm, each tensor within 2e-2 of its norm
    plus the reference's own update of it, in bf16 both (an MoE
    model's router in f32)."""
    from repro.configs import get_arch as jax_get_arch
    from repro.configs.common import ShapeSpec as JaxShapeSpec
    from repro.launch import steps as jax_steps
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro.models import transformer as jtf
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as ttf
    from repro_torch.models.convert import transformer_params_from_jax
    from repro_torch.optim.optimizers import tree_leaves

    batch, seq = 2, 32
    build = jax_steps.build_sce_config
    monkeypatch.setattr(jax_steps, "build_sce_config",
                        lambda *a, **kw: build(*a, **dict(kw,
                                                          use_kernel=False)))
    jarch = jax_get_arch(arch_name)
    jcfg = dataclasses.replace(jarch.make_smoke_config(), dtype="bfloat16")
    cfg = _port_config(jcfg)
    arch = get_arch(arch_name)
    dims = {"global_batch": batch, "seq_len": seq}
    jstep, (jinit, _), jsce = jax_steps.make_lm_train_step(
        jarch, jcfg, jax_host_mesh(max_data=batch),
        JaxShapeSpec("train_smoke", "train", dims), sce_mode="exact")
    tstep, (tinit, _), _ = steps.make_lm_train_step(
        arch, cfg, ShapeSpec("train_smoke", "train", dims),
        mesh=make_host_mesh(max_data=batch), sce_mode="exact")
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = transformer_params_from_jax(
        jax.tree.map(lambda a: np.array(a, copy=True), jp), device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    start = [t.clone() for t in tree_leaves(tp)]
    js, ts = jinit(jp), tinit(tp)
    data = SequenceDataset(SeqDataConfig(n_items=cfg.vocab, seq_len=seq,
                                         batch_size=batch, min_len_frac=1.0))
    cur = Cursor(seed=0)
    jstep = jax.jit(jstep)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    guard.set_policy("off")
    try:
        for i in range(2):
            b, cur = data.next_batch(cur)
            key = jax.random.PRNGKey(300 + i)
            om = jax.random.normal(jax.random.fold_in(key, 0),
                                   (jsce.n_buckets, batch * seq),
                                   jnp.float32)
            jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b), key)
            tp, ts, tm = tstep(tp, ts, train.to_device(b, "cpu"),
                               omega=torch.from_numpy(np.array(om)))
            assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                      rel=2e-2)
    finally:
        guard.set_policy(None)
        torch.set_num_threads(before)
    want = transformer_params_from_jax(
        jax.tree.map(lambda a: np.array(a, copy=True), jp), device="cpu")
    leaves, wleaves = tree_leaves(tp), tree_leaves(want)
    assert len(leaves) == len(wleaves) == len(start) > 0
    # bf16 but an MoE model's f32 router
    assert [t.dtype for t in leaves].count(torch.float32) == (
        0 if cfg.moe is None else 1)
    for i, (got, ref_, p0) in enumerate(zip(leaves, wleaves, start)):
        assert got.dtype == ref_.dtype, i
        err = (got.double() - ref_.double()).norm()
        step = (ref_.double() - p0.double()).norm()
        assert err <= 2e-2 * ref_.double().norm() + step, (i, float(err))
    whole = torch.cat([t.double().reshape(-1) for t in wleaves])
    diff = torch.cat([(a.double() - b.double()).reshape(-1)
                      for a, b in zip(leaves, wleaves)])
    assert diff.norm() <= 2e-2 * whole.norm()


def test_trainer_kimi_adafactor_resumes_bit_for_bit(tmp_path):
    """``train("kimi-k2-1t-a32b", device="cpu")`` at its smoke config (MoE
    with a shared expert, Adafactor's factored state in the checkpoint):
    5 steps equal 3 steps plus a run resumed from their checkpoint bit
    for bit."""
    kw = dict(batch=BATCH, seq_len=16, seed=0, log_every=0, device="cpu")
    straight = train.train("kimi-k2-1t-a32b", steps=5, **kw)
    ck = str(tmp_path / "ck")
    first = train.train("kimi-k2-1t-a32b", steps=3, ckpt_dir=ck,
                        ckpt_every=3, **kw)
    resumed = train.train("kimi-k2-1t-a32b", steps=5, ckpt_dir=ck,
                          ckpt_every=3, **kw)
    assert resumed["steps"] == 2
    assert first["losses"] + resumed["losses"] == straight["losses"]
    assert all(np.isfinite(straight["losses"]))
