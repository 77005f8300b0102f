"""The port's training step and trainer against the JAX package's.

``make_seqrec_train_step`` of both packages (the reference single-device,
``mesh=None``, on its kernel path in Pallas interpret mode) takes three
steps from the same weights (``sasrec_params_from_jax``) on the same
batches (``SequenceDataset``, ``Cursor(seed)``). The reference draws its
Mix Ω inside the step from ``jax.random.split(key, 3)[1]``; the test
draws the same array and injects it into the port's step.

The reference runs with its kernel guard off: the guard's conformance
canaries only decide whether its kernel path runs at all (they pass on
this path), and skipping them halves the reference's compile time.

The step with another registry loss (``dataclasses.replace(arch,
train_loss=name)`` for ``ce_fused_linear``, ``ce_fused``, ``ce_chunked``
and ``ce``, none of which draws at random) takes three steps on both
sides the same way; the JAX kernels run in interpret mode.

Tolerances: loss and grad norm within ``1e-5`` relative per step;
params within ``1e-5·max|p|`` per tensor. Adam turns f32 fold-order noise
on a near-zero gradient into a full ±lr step, so elements whose reference
gradient is below ``1e-5·max|g|`` are held only to that bound,
``2·lr`` per step taken.
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
from repro.kernels import guard
from repro.launch import steps as jax_steps
from repro.models import sasrec as jax_sasrec
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
from repro_torch.launch import steps, train
from repro_torch.models import sasrec
from repro_torch.models.convert import sasrec_params_from_jax
from repro_torch.optim.optimizers import tree_leaves, tree_map

BATCH = 2
N_STEPS = 3
LR = 1e-3
B1 = 0.9


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def runs():
    """Three steps of the reference and of the port from the same state;
    per step the loss, grad norm, params and (reference) moments."""
    jarch = jax_get_arch("sasrec-sce")
    jcfg = jarch.make_smoke_config()
    arch = get_arch("sasrec-sce")
    cfg = arch.make_smoke_config()
    guard.set_policy("off")
    try:
        jstep, (jinit, _), jsce = jax_steps.make_seqrec_train_step(
            jarch, jcfg, None, JaxShapeSpec("train_smoke", "train",
                                            {"batch": BATCH}))
        jstep = jax.jit(jstep)
        tstep, (tinit, _), tsce = steps.make_seqrec_train_step(
            arch, cfg, ShapeSpec("train_smoke", "train", {"batch": BATCH}))
        jp = jax_sasrec.init_params(jax.random.PRNGKey(0), jcfg)
        js = jinit(jp)
        tp = sasrec_params_from_jax(_np_tree(jp), device="cpu")
        ts = tinit(tp)
        jdata = JaxSequenceDataset(JaxSeqDataConfig(
            n_items=jcfg.n_items, seq_len=jcfg.max_len, batch_size=BATCH))
        data = SequenceDataset(SeqDataConfig(
            n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=BATCH))
        jcur, cur = JaxCursor(seed=0), Cursor(seed=0)
        out = {"jax": [], "torch": [], "sce": (jsce, tsce)}
        n = BATCH * cfg.max_len
        for i in range(N_STEPS):
            jb, jcur = jdata.next_batch(jcur)
            tb, cur = data.next_batch(cur)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
            key = jax.random.PRNGKey(100 + i)
            omega = jax.random.normal(jax.random.split(key, 3)[1],
                                      (jsce.n_buckets, n), jnp.float32)
            m_prev = _np_tree(js.inner["m"])
            jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, jb), key)
            tp, ts, tm = tstep(tp, ts, train.to_device(tb, "cpu"),
                               omega=torch.from_numpy(np.array(omega)))
            # The reference's gradient, from its first moment:
            # m = b1·m_prev + (1 − b1)·g.
            grads = jax.tree.map(
                lambda m, mp: (np.asarray(m) - B1 * mp) / (1 - B1),
                js.inner["m"], m_prev)
            out["jax"].append(dict(
                loss=float(jm["loss"]), grad_norm=float(jm["grad_norm"]),
                skipped=bool(jm["skipped"]), params=_np_tree(jp),
                grads=grads, step=int(js.step)))
            out["torch"].append(dict(
                loss=float(tm["loss"]), grad_norm=float(tm["grad_norm"]),
                skipped=bool(tm["skipped"]),
                params=[p.numpy().copy() for p in tree_leaves(tp)],
                step=int(ts.step)))
        return out
    finally:
        guard.set_policy(None)


def test_sce_config_matches_reference(runs):
    jsce, tsce = runs["sce"]
    assert (tsce.n_buckets, tsce.bucket_size_x, tsce.bucket_size_y,
            tsce.use_mix, tsce.use_kernel, tsce.logit_softcap) == \
        (jsce.n_buckets, jsce.bucket_size_x, jsce.bucket_size_y,
         jsce.use_mix, jsce.use_kernel, jsce.logit_softcap)
    assert tsce.use_kernel  # the step runs the kernel path


@pytest.mark.parametrize("i", range(N_STEPS))
def test_step_loss_and_grad_norm_match_reference(runs, i):
    j, t = runs["jax"][i], runs["torch"][i]
    assert not t["skipped"] and not j["skipped"]
    assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
    assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-5)
    assert t["step"] == j["step"] == i + 1


@pytest.mark.parametrize("i", range(N_STEPS))
def test_step_params_match_reference(runs, i):
    j, t = runs["jax"][i], runs["torch"][i]
    noisy = [np.zeros(g.shape, bool) for g in jax.tree.leaves(j["grads"])]
    for s in range(i + 1):  # an element noisy at any step so far
        for k, g in enumerate(jax.tree.leaves(runs["jax"][s]["grads"])):
            noisy[k] |= np.abs(g) < 1e-5 * np.abs(g).max()
    for want, got, mask in zip(jax.tree.leaves(j["params"]), t["params"],
                               noisy):
        diff = np.abs(got - want)
        tol = 1e-5 * np.abs(want).max()
        assert (diff[~mask] <= tol).all(), diff[~mask].max()
        assert (diff[mask] <= 2 * LR * (i + 1)).all()


def test_microbatch_accumulation_matches_reference():
    """Two microbatches: the mean loss and the mean gradient, summed in
    the accumulator dtype and cast back, as the reference's scan does."""
    rng = np.random.default_rng(4)
    batch = {"a": rng.standard_normal((4, 3)).astype(np.float32)}
    w = rng.standard_normal(3).astype(np.float32)

    def jax_fn(params, mb, key):
        loss = jnp.sum(mb["a"] @ params["w"])
        return loss, {"w": jnp.sum(mb["a"], axis=0) * loss}

    def torch_fn(params, mb, generator, omega):
        loss = (mb["a"] @ params["w"]).sum()
        return loss, {"w": mb["a"].sum(0) * loss}

    want_loss, want_g = jax_steps._accumulate_microbatches(
        jax_fn, {"w": jnp.asarray(w)}, jax.tree.map(jnp.asarray, batch),
        jax.random.PRNGKey(0), 2)
    got_loss, got_g = steps._accumulate_microbatches(
        torch_fn, {"w": torch.from_numpy(w)},
        {"a": torch.from_numpy(batch["a"])}, None, 2)
    assert got_loss.item() == pytest.approx(float(want_loss), rel=1e-6)
    np.testing.assert_allclose(got_g["w"].numpy(), np.asarray(want_g["w"]),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="single microbatch"):
        steps._accumulate_microbatches(torch_fn, {"w": torch.from_numpy(w)},
                                       {"a": torch.from_numpy(batch["a"])},
                                       None, 2, omega=torch.zeros(1))


def test_guarded_skip_keeps_params_and_state_bitwise():
    """A NaN in the params: the step reports ``skipped`` and returns the
    params and the optimizer state bit for bit as they were, the step
    counter included; a loss above ``loss_cap`` is skipped the same way."""
    arch = get_arch("sasrec-sce")
    cfg = arch.make_smoke_config()
    step_fn, (opt_init, _), _ = steps.make_seqrec_train_step(
        arch, cfg, ShapeSpec("train_smoke", "train", {"batch": BATCH}))
    params = sasrec.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=BATCH))
    batch, _ = data.next_batch(Cursor(seed=0))
    batch = train.to_device(batch, "cpu")
    params, state, m = step_fn(params, opt_init(params), batch,
                               generator=gen)
    assert not bool(m["skipped"]) and int(state.step) == 1

    def bits(tree):
        return [t.view(torch.int32).clone() if t.is_floating_point()
                else t.clone() for t in tree_leaves(tree)]

    poisoned = tree_map(lambda p: p.clone(), params)
    poisoned["layers"]["w1"][0, 0, 0] = float("nan")
    before = bits(poisoned), bits(state.inner), int(state.step)
    p2, s2, m2 = step_fn(poisoned, state, batch, generator=gen)
    assert bool(m2["skipped"])
    after = bits(p2), bits(s2.inner), int(s2.step)
    assert before[2] == after[2] == 1
    for a, b in zip(before[0] + before[1], after[0] + after[1]):
        assert torch.equal(a, b)

    capped = dict(batch, loss_cap=torch.tensor(0.0))
    p3, s3, m3 = step_fn(params, state, capped, generator=gen)
    assert bool(m3["skipped"]) and int(s3.step) == 1
    assert all(torch.equal(a, b) for a, b in zip(bits(p3), bits(params)))


def test_autograd_through_forward_matches_reference():
    """Gradients of a fixed projection of the hidden states reach every
    parameter leaf, the token gather's into ``item_emb``, as JAX's do."""
    jcfg = jax_get_arch("sasrec-sce").make_smoke_config()
    cfg = get_arch("sasrec-sce").make_smoke_config()
    jp = _np_tree(jax_sasrec.init_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.n_items, (2, cfg.max_len)).astype(np.int32)
    w = rng.standard_normal((2, cfg.max_len, cfg.d_model)).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(jax_sasrec.forward(
        p, jcfg, jnp.asarray(tokens)) * w)))(jax.tree.map(jnp.asarray, jp))
    leaves = tree_map(lambda p: p.requires_grad_(True),
                      sasrec_params_from_jax(jp, device="cpu"))
    out = (sasrec.forward(leaves, cfg, torch.from_numpy(tokens))
           * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(out, tree_leaves(leaves))
    for g, wg in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=2e-4,
                                   atol=1e-5 * np.abs(np.asarray(wg)).max())
    emb_rows = got[tree_leaves(leaves).index(leaves["item_emb"])]
    untouched = np.setdiff1d(np.arange(cfg.n_rows), tokens)
    assert (emb_rows[untouched] == 0).all()
    assert (emb_rows[np.unique(tokens)].abs().sum(-1) > 0).all()


def test_trainer_runs_on_cpu():
    out = train.train("sasrec-sce", steps=3, device="cpu", log_every=0)
    assert out["steps"] == 3 and out["skipped_steps"] == 0
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["first_loss"] == out["losses"][0]
    assert out["final_loss"] == out["losses"][-1]
    assert out["mean_step_s"] > 0


def test_trainer_marks_each_phase_in_order():
    """The ``mark`` hook sees every phase of every step, in order, and
    changes nothing the steps compute."""
    seen = []
    out = train.train("sasrec-sce", steps=2, device="cpu", log_every=0,
                      mark=seen.append)
    phases = ["start", "h2d", "forward", "select", "loss_forward",
              "backward", "optimizer"]
    assert seen == phases * 2
    plain = train.train("sasrec-sce", steps=2, device="cpu", log_every=0)
    assert out["losses"] == plain["losses"]


def test_train_cli_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "sasrec-sce", "--steps", "2", "--batch", "3",
        "--device", "cpu", "--log-every", "1",
    ])
    train.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("step     0")
    assert '"steps": 2' in lines[-1]


def test_trainer_without_device_needs_cuda(monkeypatch):
    """No device given and no CUDA: the trainer raises instead of running
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train("sasrec-sce", steps=1)


FULL_CE_LOSSES = ("ce_fused_linear", "ce_fused", "ce_chunked", "ce")


@pytest.mark.parametrize("loss_name", FULL_CE_LOSSES)
def test_step_with_full_ce_loss_matches_reference(loss_name):
    """Three steps with ``train_loss`` set to a full-CE registry name:
    loss and grad norm equal the reference step's within 1e-5 relative,
    and the phase marks are the non-SCE ones."""
    jarch = dataclasses.replace(jax_get_arch("sasrec-sce"),
                                train_loss=loss_name)
    arch = dataclasses.replace(get_arch("sasrec-sce"), train_loss=loss_name)
    jcfg = jarch.make_smoke_config()
    cfg = arch.make_smoke_config()
    guard.set_policy("off")
    try:
        jstep, (jinit, _), _ = jax_steps.make_seqrec_train_step(
            jarch, jcfg, None, JaxShapeSpec("train_smoke", "train",
                                            {"batch": BATCH}))
        jstep = jax.jit(jstep)
        tstep, (tinit, _), _ = steps.make_seqrec_train_step(
            arch, cfg, ShapeSpec("train_smoke", "train", {"batch": BATCH}))
        jp = jax_sasrec.init_params(jax.random.PRNGKey(0), jcfg)
        js = jinit(jp)
        tp = sasrec_params_from_jax(_np_tree(jp), device="cpu")
        ts = tinit(tp)
        data = SequenceDataset(SeqDataConfig(
            n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=BATCH))
        cur = Cursor(seed=0)
        for i in range(N_STEPS):
            batch, cur = data.next_batch(cur)
            jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch),
                               jax.random.PRNGKey(100 + i))
            marks = []
            tp, ts, tm = tstep(tp, ts, train.to_device(batch, "cpu"),
                               mark=marks.append)
            assert marks == ["forward", "loss_forward", "backward",
                             "optimizer"]
            assert not bool(tm["skipped"]) and not bool(jm["skipped"])
            assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                      rel=1e-5)
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=1e-5)
    finally:
        guard.set_policy(None)


def test_step_rejects_an_unknown_loss_and_omega_off_sce():
    arch = get_arch("sasrec-sce")
    cfg = arch.make_smoke_config()
    shape = ShapeSpec("train_smoke", "train", {"batch": BATCH})
    params = sasrec.init_params(cfg, seed=0, device="cpu")
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=BATCH))
    batch = train.to_device(data.next_batch(Cursor(seed=0))[0], "cpu")
    step, (opt_init, _), _ = steps.make_seqrec_train_step(
        dataclasses.replace(arch, train_loss="no_such_loss"), cfg, shape)
    with pytest.raises(KeyError, match="unknown loss"):
        step(params, opt_init(params), batch)
    step, (opt_init, _), _ = steps.make_seqrec_train_step(
        dataclasses.replace(arch, train_loss="ce"), cfg, shape)
    with pytest.raises(ValueError, match="omega"):
        step(params, opt_init(params), batch, omega=torch.zeros(1))


def test_exact_step_on_one_by_one_mesh_matches_reference(monkeypatch):
    """The reference trainer's default path on one device: three steps of
    ``make_seqrec_train_step(..., mesh, sce_mode="exact")`` on a (1, 1)
    mesh (``sce_loss_sharded``) on both sides. The reference runs its
    plain selection (``build_sce_config`` patched to ``use_kernel=False``:
    with the kernel flag its chunked ``mips_topk_ref`` fails inside
    ``shard_map`` on jax 0.9, ROADMAP queue 3); the port its kernel path
    (on the CPU the plain ``mips_topk`` and ``sce_gather_plse``
    versions). Ω is the reference's own draw, ``fold_in(k_loss, 0)``."""
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro_torch.launch.mesh import make_host_mesh

    build = jax_steps.build_sce_config
    monkeypatch.setattr(jax_steps, "build_sce_config",
                        lambda *a, **kw: build(*a, **dict(kw,
                                                          use_kernel=False)))
    jarch = jax_get_arch("sasrec-sce")
    jcfg = jarch.make_smoke_config()
    arch = get_arch("sasrec-sce")
    cfg = arch.make_smoke_config()
    guard.set_policy("off")
    try:
        jmesh = jax_host_mesh(max_data=BATCH)
        assert dict(jmesh.shape) == {"data": 1, "model": 1}
        jstep, (jinit, _), jsce = jax_steps.make_seqrec_train_step(
            jarch, jcfg, jmesh, JaxShapeSpec("train_smoke", "train",
                                             {"batch": BATCH}),
            sce_mode="exact")
        jstep = jax.jit(jstep)
        mesh = make_host_mesh(max_data=BATCH)
        tstep, (tinit, _), tsce = steps.make_seqrec_train_step(
            arch, cfg, ShapeSpec("train_smoke", "train", {"batch": BATCH}),
            mesh=mesh, sce_mode="exact")
        assert not jsce.use_kernel and tsce.use_kernel
        assert (tsce.n_buckets, tsce.bucket_size_x, tsce.bucket_size_y) == \
            (jsce.n_buckets, jsce.bucket_size_x, jsce.bucket_size_y)
        jp = jax_sasrec.init_params(jax.random.PRNGKey(0), jcfg)
        js = jinit(jp)
        tp = sasrec_params_from_jax(_np_tree(jp), device="cpu")
        ts = tinit(tp)
        data = SequenceDataset(SeqDataConfig(
            n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=BATCH))
        cur = Cursor(seed=0)
        n = BATCH * cfg.max_len
        for i in range(N_STEPS):
            batch, cur = data.next_batch(cur)
            key = jax.random.PRNGKey(200 + i)
            k_loss = jax.random.split(key, 3)[1]
            omega = jax.random.normal(jax.random.fold_in(k_loss, 0),
                                      (jsce.n_buckets, n), jnp.float32)
            jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch), key)
            marks = []
            tp, ts, tm = tstep(tp, ts, train.to_device(batch, "cpu"),
                               omega=torch.from_numpy(np.array(omega)),
                               mark=marks.append)
            assert marks == ["forward", "select", "loss_forward",
                             "backward", "optimizer"]
            assert not bool(tm["skipped"]) and not bool(jm["skipped"])
            assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                      rel=1e-5)
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=1e-5)
    finally:
        guard.set_policy(None)


@pytest.mark.parametrize("mode", ["exact", "union"])
def test_trainer_default_mode_is_exact_and_agrees_with_gspmd(mode):
    """``train()`` runs distributed SCE by default (exact, on the (1, 1)
    host mesh); on one device both distributed modes select what the
    global-bucket ``gspmd`` loss selects from the same generator draw, so
    the three give the same losses within 1e-5."""
    import inspect

    assert inspect.signature(train.train).parameters["sce_mode"].default \
        == "exact"
    got = train.train("sasrec-sce", steps=2, device="cpu", log_every=0,
                      sce_mode=mode)
    want = train.train("sasrec-sce", steps=2, device="cpu", log_every=0,
                       sce_mode="gspmd")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)


def test_step_path_follows_mesh_and_sce_mode(monkeypatch):
    """``mesh=None`` and ``sce_mode="gspmd"`` keep ``core.sce.sce_loss``;
    a mesh with ``exact``/``union`` runs ``sce_loss_sharded``; an unknown
    mode raises, and a data axis > 1 takes distributed SCE only."""
    from repro_torch.dist.sharding import Mesh
    from repro_torch.launch.mesh import make_host_mesh

    arch = get_arch("sasrec-sce")
    cfg = arch.make_smoke_config()
    shape = ShapeSpec("train_smoke", "train", {"batch": BATCH})
    params = sasrec.init_params(cfg, seed=0, device="cpu")
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=BATCH))
    batch = train.to_device(data.next_batch(Cursor(seed=0))[0], "cpu")
    calls = []
    for name in ("sce_loss", "sce_loss_sharded"):
        real = getattr(steps, name)
        monkeypatch.setattr(steps, name, lambda *a, _n=name, _f=real, **kw:
                            calls.append(_n) or _f(*a, **kw))
    mesh = make_host_mesh(max_data=BATCH)
    for kw, want in ((dict(), "sce_loss"),
                     (dict(mesh=mesh, sce_mode="gspmd"), "sce_loss"),
                     (dict(mesh=mesh), "sce_loss_sharded"),
                     (dict(mesh=mesh, sce_mode="union"), "sce_loss_sharded")):
        step, (opt_init, _), _ = steps.make_seqrec_train_step(
            arch, cfg, shape, **kw)
        step(params, opt_init(params), batch,
             generator=torch.Generator().manual_seed(0))
        assert calls.pop() == want and not calls
    with pytest.raises(ValueError, match="sce_mode"):
        steps.make_seqrec_train_step(arch, cfg, shape, sce_mode="ring")
    # every loss now runs on a data axis > 1 (against one process's
    # global step: tests/test_torch_dist_train.py), microbatches too
    wide = Mesh({"data": 2, "model": 1}, {"data": 0, "model": 0},
                {"data": None, "model": None})
    steps.make_seqrec_train_step(arch, cfg, shape, mesh=wide,
                                 sce_mode="gspmd")
    assert steps.n_microbatches(arch, shape, wide) == 1
    outside = Mesh({"data": 1, "model": 1}, None,
                   {"data": None, "model": None})
    with pytest.raises(ValueError, match="outside"):
        steps.make_seqrec_train_step(arch, cfg, shape, mesh=outside)


def test_train_cli_takes_sce_mode(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "sasrec-sce", "--steps", "1", "--batch", "2",
        "--device", "cpu", "--sce-mode", "union",
    ])
    train.main()
    assert '"steps": 1' in capsys.readouterr().out.strip().splitlines()[-1]


# ---------------------------------------------------------------------------
# The divergence guard and the kernel guard's sentinels in the trainer
# ---------------------------------------------------------------------------
def _reference_raise_step(losses, chaos_at, max_strikes):
    """The step at which the reference trainer (no ``--ckpt-dir``) raises:
    its own ``DivergenceGuard`` fed the finite losses before the poisoned
    params and NaN from ``chaos_at`` on (the update is skipped, so the
    params stay NaN)."""
    from repro.launch.elastic import DivergenceGuard as JaxGuard

    g = JaxGuard(max_strikes=max_strikes)
    for step in range(len(losses) + max_strikes + 1):
        bad = step >= chaos_at
        loss = float("nan") if bad else losses[step]
        if g.observe(loss, skipped=bad) == "rollback":
            return step
    raise AssertionError("the reference guard never rolled back")


@pytest.fixture
def _port_guard_reset():
    from repro_torch.kernels import guard as tguard

    yield
    tguard.set_policy(None)


@pytest.mark.parametrize("chaos_at,max_strikes", [(2, 3), (3, 2)])
def test_trainer_divergence_drill_raises_at_reference_step(
        capsys, _port_guard_reset, chaos_at, max_strikes):
    healthy = train.train("sasrec-sce", steps=chaos_at, batch=2,
                          device="cpu", log_every=0)["losses"]
    want = _reference_raise_step(healthy, chaos_at, max_strikes)
    with pytest.raises(RuntimeError,
                       match=f"diverged for {max_strikes} consecutive steps "
                             f"at step {want} and no --ckpt-dir"):
        train.train("sasrec-sce", steps=10, batch=2, device="cpu",
                    log_every=0, chaos_nan_at=chaos_at,
                    max_strikes=max_strikes, guard_policy="strict")
    out = capsys.readouterr().out.splitlines()
    assert f"[chaos] step {chaos_at}: poisoning params with NaN" in out
    strikes = [line for line in out if line.startswith("[guard] step")]
    assert len(strikes) == max_strikes
    for i, line in enumerate(strikes):
        assert line.startswith(f"[guard] step {chaos_at + i}: loss nan")
        assert f"update skipped (strike {i + 1}/{max_strikes})" in line
        assert "(sentinels: sce_bucket_nonfinite=1)" in line


def test_every_batch_carries_the_loss_cap(monkeypatch):
    """The cap rides in every batch as a 0-d f32 tensor: ``inf`` for the
    first 8 healthy steps, then ``guard_factor`` × the running median of
    the losses so far; sentinels are zero on healthy steps."""
    seen = []
    make = train.make_seqrec_train_step

    def recording(*a, **kw):
        step_fn, opt, sce_cfg = make(*a, **kw)

        def step(params, opt_state, batch, **skw):
            seen.append(batch["loss_cap"])
            return step_fn(params, opt_state, batch, **skw)

        return step, opt, sce_cfg

    monkeypatch.setattr(train, "make_seqrec_train_step", recording)
    out = train.train("sasrec-sce", steps=10, batch=2, device="cpu",
                      log_every=0, guard_factor=50.0)
    assert len(seen) == 10
    assert all(c.shape == () and c.dtype == torch.float32 for c in seen)
    caps = [float(c) for c in seen]
    assert caps == out["loss_caps"]
    assert caps[:8] == [float("inf")] * 8
    for i in (8, 9):
        want = 50.0 * float(np.median(out["losses"][:i]))
        assert caps[i] == pytest.approx(want, rel=1e-6)
    assert out["skipped_steps"] == 0
    assert all(s == {"sce_bucket_nonfinite": 0} for s in out["sentinels"])


def test_trainer_guard_off_has_no_sentinels(_port_guard_reset):
    out = train.train("sasrec-sce", steps=2, batch=2, device="cpu",
                      log_every=0, guard_policy="off")
    assert out["sentinels"] == [{}, {}]


def test_train_cli_takes_the_guard_flags(monkeypatch, capsys,
                                         _port_guard_reset):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "sasrec-sce", "--steps", "6", "--batch", "2",
        "--device", "cpu", "--guard", "warn", "--max-strikes", "2",
        "--guard-factor", "10", "--chaos-nan-at", "3", "--log-every", "0",
    ])
    with pytest.raises(RuntimeError, match="at step 4"):
        train.main()
    out = capsys.readouterr().out
    assert "(strike 2/2)" in out
