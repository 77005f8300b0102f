"""The port's SCE training step and trainer against the JAX package's.

``make_seqrec_train_step`` of both packages (the reference single-device,
``mesh=None``, on its kernel path in Pallas interpret mode) takes three
steps from the same weights (``sasrec_params_from_jax``) on the same
batches (``SequenceDataset``, ``Cursor(seed)``). The reference draws its
Mix Ω inside the step from ``jax.random.split(key, 3)[1]``; the test
draws the same array and injects it into the port's step.

The reference runs with its kernel guard off: the guard's conformance
canaries only decide whether its kernel path runs at all (they pass on
this path), and skipping them halves the reference's compile time.

Tolerances: loss and grad norm within ``1e-5`` relative per step;
params within ``1e-5·max|p|`` per tensor. Adam turns f32 fold-order noise
on a near-zero gradient into a full ±lr step, so elements whose reference
gradient is below ``1e-5·max|g|`` are held only to that bound,
``2·lr`` per step taken.
"""
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
