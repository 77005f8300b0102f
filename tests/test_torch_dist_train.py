"""The rest of the port's data-parallel training against the JAX package
and against one process's global step.

* int8 error-feedback compression (``optim/compression.py``):
  ``compress_int8`` / ``decompress_int8`` / ``compressed_gradient_transform``
  bit for bit the reference's (round half to even, the zero leaf's
  scale, a bf16 leaf), the telescoping sum of the error feedback over
  several steps, the wrapped optimizer's in-place guarded update against
  its functional one and the reference's, a compressed train step
  against the reference's, and a checkpointed compressed run that repeats
  the uninterrupted one bit for bit, residual included.
* ``--n-hosts``: ``launch/train.py::_host_batch`` at 1, 2 and 4 hosts bit
  for bit the reference's, and the one-host batch.
* On a ``(2, 1)`` mesh of ``gloo`` processes (``tests/_dist_workers.py``,
  task ``dtrain``): two steps with 2 microbatches (each rank on its block
  of every global microbatch), ``ce_fused_linear`` / ``ce_fused`` (the
  shards' sums and counts summed), a sampled loss and BERT4Rec's cloze
  draw (the global rows, one process's draws), and gemma-2's smoke LM,
  each against one process's global step, and the two losses that draw
  nothing also against the reference's ``mesh=None`` step on the same
  global batch from the same weights: losses and gradient norms
  within ``1e-5`` relative, the parameters after two AdamW steps at lr
  ``1e-3`` within ``1e-5`` (the f32 sums run in another order, and
  AdamW's ``m/√v`` magnifies a near-zero gradient's noise).
* Checkpoints over several processes: a run saved on a world of 2
  resumes on a world of 1, and one saved on 1 resumes on 2, each
  continuing the uninterrupted one-process run within ``1e-5``; the
  wall-clock policy on 2 processes saves at its interval.
"""
import dataclasses
import json

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
from repro.kernels import guard as jax_guard
from repro.launch import steps as jax_steps
from repro.launch import train as jax_train
from repro.models import sasrec as jax_sasrec
from repro.optim import compression as jcomp
from repro.optim.optimizers import make_optimizer as jax_make_optimizer
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
from repro_torch.dist.sharding import Mesh, batch_rows
from repro_torch.kernels import guard
from repro_torch.launch import steps, train
from repro_torch.models import sasrec
from repro_torch.models.convert import sasrec_params_from_jax
from repro_torch.optim import (
    ErrorFeedbackState,
    compress_int8,
    compressed_gradient_transform,
    decompress_int8,
    init_error_feedback,
    make_optimizer,
    with_error_feedback_compression,
)
from repro_torch.optim.optimizers import tree_leaves
from _dist_workers import dp_steps, flatten_tree
from test_torch_distributed_sce import _start, _wait

DP_CASES = [  # ``jax``: no random draw, so also held against the reference
    dict(name="ce_fused_linear_2mb", arch="sasrec-sce",
         loss="ce_fused_linear", shape="train_smoke", micro=2, batch=8,
         jax=True),
    dict(name="ce_fused", arch="sasrec-sce", loss="ce_fused",
         shape="train_smoke", micro=1, batch=4, jax=True),
    dict(name="bce_plus_2mb", arch="sasrec-sce", loss="bce_plus",
         shape="train_smoke", micro=2, batch=8),
    dict(name="bert4rec_4mb", arch="bert4rec", loss="ce_fused_linear",
         shape="train_batch", micro=4, batch=8),
    dict(name="gemma_2mb", arch="gemma2-2b", loss="ce_fused_linear",
         shape="train_4k", micro=2, batch=4, seq=16),
]
for _c in DP_CASES:
    _c.setdefault("mode", "exact")
JAX_CASES = [c for c in DP_CASES if c.get("jax")]
LR = 1e-3  # the steps' AdamW
CKPT_KW = dict(batch=4, device="cpu", log_every=0, train_loss="ce_fused_linear",
               grad_compression="int8", ckpt_every=2)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The (2, 1) world's results, one process's global steps, and the
    checkpoint runs: one process saves ``there`` first, the world saves
    ``here`` and resumes ``there``."""
    root = tmp_path_factory.mktemp("dtrain")
    jp = jax_sasrec.init_params(jax.random.PRNGKey(0),
                                jax_get_arch("sasrec-sce").make_smoke_config())
    inputs = flatten_tree(sasrec_params_from_jax(_np_tree(jp), device="cpu"),
                          "jaxp")
    one = train.train("sasrec-sce", steps=4, **CKPT_KW)
    first = train.train("sasrec-sce", steps=2, ckpt_dir=str(root / "there"),
                        **CKPT_KW)
    spec = {"tasks": ["dtrain"], "dp_cases": DP_CASES,
            "ckpt_here": str(root / "here"), "ckpt_there": str(root / "there"),
            "ckpt_interval": str(root / "interval"), "interval_steps": 8,
            "interval_s": 3.0}
    launch = _start(root / "w", 2, spec, inputs)
    single = {}
    dp_steps(spec, single, inputs=inputs)  # meanwhile, one process's steps
    ref = {c["name"]: _reference_steps(c, jp) for c in JAX_CASES}
    (ranks,) = _wait([launch])
    return {"ranks": ranks, "single": single, "ref": ref, "one": one,
            "first": first, "root": root}


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _reference_steps(case, jp):
    """The reference's single-device step (``mesh=None``) on the same
    global batches from the same weights: per step the loss, the grad
    norm, the parameters and the gradient (from AdamW's first moment),
    the last two in the port's layout."""
    jarch = dataclasses.replace(jax_get_arch(case["arch"]),
                                train_loss=case["loss"],
                                microbatches={case["shape"]: case["micro"]})
    jcfg = jarch.make_smoke_config()
    gb = case["batch"]
    jax_guard.set_policy("off")  # its canaries only gate the kernel path
    try:
        jstep, (jinit, _), _ = jax_steps.make_seqrec_train_step(
            jarch, jcfg, None, JaxShapeSpec(case["shape"], "train",
                                            {"batch": gb}))
        jstep = jax.jit(jstep)
        js = jinit(jp)
        data = SequenceDataset(SeqDataConfig(
            n_items=jcfg.n_items, seq_len=jcfg.max_len, batch_size=gb))
        cur, out = Cursor(seed=0), []
        for i in range(2):
            batch, cur = data.next_batch(cur)
            m_prev = _np_tree(js.inner["m"])
            jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch),
                               jax.random.PRNGKey(100 + i))
            grads = jax.tree.map(lambda m, mp: (np.asarray(m) - 0.9 * mp)
                                 / 0.1, js.inner["m"], m_prev)
            out.append({
                "loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"]),
                "params": flatten_tree(sasrec_params_from_jax(
                    _np_tree(jp), device="cpu"), "p"),
                "grads": flatten_tree(sasrec_params_from_jax(
                    grads, device="cpu"), "p")})
        return out
    finally:
        jax_guard.set_policy(None)


@pytest.mark.parametrize("case", DP_CASES, ids=[c["name"] for c in DP_CASES])
def test_data_parallel_step_matches_one_process(world2, case):
    tag = f"dp_{case['name']}"
    single, ranks = world2["single"], world2["ranks"]
    assert int(ranks[0][f"{tag}_n_micro"]) == case["micro"]
    for r in ranks:
        for what in ("losses", "grad_norms"):
            np.testing.assert_allclose(r[f"{tag}_{what}"],
                                       single[f"{tag}_{what}"], rtol=1e-5)
        keys = [k for k in single if k.startswith(f"{tag}_p/")]
        assert keys
        for k in keys:  # AdamW at lr 1e-3 moves a weight by ≤ ~1e-3 a step
            np.testing.assert_allclose(r[k], single[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    for k in ranks[0]:  # the ranks hold one replicated state
        if k.startswith(tag):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


@pytest.mark.parametrize("case", JAX_CASES, ids=[c["name"] for c in JAX_CASES])
def test_data_parallel_step_matches_reference(world2, case):
    """The 2-rank steps of the losses that draw nothing against the
    reference's ``mesh=None`` step on the same global batch: loss and
    grad norm within ``1e-5`` relative per step, the parameters within
    ``1e-5·max|p|`` per tensor plus a thousandth of a step (the biases
    start at 0, so their ``max|p|`` is two steps), except where the
    reference's gradient was below ``1e-5·max|g|`` at a step so far
    (AdamW turns its fold-order noise into up to a full ±lr step): those
    within ``2·lr`` a step."""
    tag = f"dp_{case['name']}"
    ref = world2["ref"][case["name"]]
    for r in world2["ranks"]:
        for what in ("losses", "grad_norms"):
            want = [s["loss" if what == "losses" else "grad_norm"]
                    for s in ref]
            np.testing.assert_allclose(r[f"{tag}_{what}"], want, rtol=1e-5)
        want = ref[-1]["params"]
        assert len(want) == len([k for k in r if k.startswith(f"{tag}_p/")])
        for k, w in want.items():
            noisy = np.zeros(w.shape, bool)
            for s in ref:
                g = s["grads"][k]
                noisy |= np.abs(g) < 1e-5 * np.abs(g).max()
            diff = np.abs(r[f"{tag}_{k}"] - w)
            tol = 1e-5 * np.abs(w).max() + 1e-3 * LR
            assert (diff[~noisy] <= tol).all(), k
            assert (diff[noisy] <= 2 * LR * len(ref)).all(), k


def test_checkpoints_cross_worlds(world2, capsys):
    """Saved on 2 processes (rank 0 writes, with 2 emulated hosts in its
    cursor) → resumed on 1; saved on 1 → resumed on 2; every run continues
    the uninterrupted one-process run."""
    one = world2["one"]["losses"]
    ranks = world2["ranks"]
    np.testing.assert_allclose(world2["first"]["losses"], one[:2], rtol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["ckpt_saved_losses"], one[:2], rtol=1e-5)
        np.testing.assert_allclose(r["ckpt_resumed_losses"], one[2:],
                                   rtol=1e-5)
    here = world2["root"] / "here"
    step, tree = CheckpointManager(str(here)).restore_latest()
    assert step == 1 and tree["cursor"]["n_hosts"] == 2
    resumed = train.train("sasrec-sce", steps=4, ckpt_dir=str(here),
                          **CKPT_KW)
    assert "[restore] resumed from step 1" in capsys.readouterr().out
    np.testing.assert_allclose(resumed["losses"], one[2:], rtol=1e-5)


def test_wall_clock_saves_come_at_the_interval_on_two_processes(world2):
    """``ckpt_interval_s`` on a world of 2, on a clock that ticks once a
    reading (the manager's creation 0, each step's policy one tick, each
    save one): rank 0's save resets only its own clock and its decision
    is every rank's, so the saves come every 3 ticks, at steps 2 and 5 of
    8, and not at every step once rank 1's interval has passed."""
    mgr = CheckpointManager(str(world2["root"] / "interval"))
    assert mgr.all_steps() == [2, 5]


def test_batch_rows_take_a_block_of_every_microbatch():
    mesh = Mesh({"data": 2, "model": 1}, {"data": 1, "model": 0},
                {"data": None, "model": None})
    np.testing.assert_array_equal(batch_rows(mesh, 8, 2), [2, 3, 6, 7])
    assert batch_rows(mesh, 8, 1) == slice(4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        batch_rows(mesh, 9, 3)


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------
def _arrays():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((7, 5)).astype(np.float32) * 3,
            np.zeros((4,), np.float32),
            # exact halves of the quantum: round half to even
            np.array([127.0, 63.5, -0.5, 0.5, 1.5, -2.5, 2.5], np.float32),
            (rng.standard_normal(300) * 1e-8).astype(np.float32)]


@pytest.mark.parametrize("i", range(4))
def test_compress_int8_is_the_reference_bit_for_bit(i):
    a = _arrays()[i]
    q, scale = compress_int8(torch.from_numpy(a))
    jq, jscale = jcomp.compress_int8(jnp.asarray(a))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.item() == float(jscale)
    np.testing.assert_array_equal(
        decompress_int8(q, scale).numpy(),
        np.asarray(jcomp.decompress_int8(jq, jscale)))


def test_error_feedback_matches_reference_and_telescopes():
    """Five steps: the dequantized gradients (an f32 and a bf16 leaf) and
    the residual equal the reference's bit for bit, and on the f32 leaf
    ``Σ deq + r_T`` equals ``Σ g`` (the error feedback loses nothing; the
    bf16 leaf's dequantized values round once more, after the residual
    is taken, as in the reference)."""
    rng = np.random.default_rng(1)
    grads = [{"w": rng.standard_normal((6, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
             for _ in range(5)]
    ef = init_error_feedback({k: torch.from_numpy(v)
                              for k, v in grads[0].items()})
    jef = jcomp.init_error_feedback(grads[0])
    sum_g = {k: np.zeros_like(v, np.float64) for k, v in grads[0].items()}
    sum_d = {k: np.zeros_like(v, np.float64) for k, v in grads[0].items()}
    for g in grads:
        tg = {"w": torch.from_numpy(g["w"]),
              "b": torch.from_numpy(g["b"]).to(torch.bfloat16)}
        jg = {"w": jnp.asarray(g["w"]),
              "b": jnp.asarray(g["b"]).astype(jnp.bfloat16)}
        deq, ef = compressed_gradient_transform(tg, ef)
        jdeq, jef = jcomp.compressed_gradient_transform(jg, jef)
        for k in g:
            assert deq[k].dtype == tg[k].dtype
            np.testing.assert_array_equal(
                deq[k].float().numpy(), np.asarray(jdeq[k], np.float32))
            np.testing.assert_array_equal(ef.residual[k].numpy(),
                                          np.asarray(jef.residual[k]))
            sum_g[k] += tg[k].double().numpy()
            sum_d[k] += deq[k].double().numpy()
    np.testing.assert_allclose(sum_d["w"] + ef.residual["w"].double().numpy(),
                               sum_g["w"], rtol=0, atol=1e-5)


def test_compressed_optimizer_in_place_equals_functional_and_reference():
    rng = np.random.default_rng(2)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    gs = [{k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in p0.items()} for _ in range(3)]
    init, update = with_error_feedback_compression(make_optimizer("adamw",
                                                                  1e-2))
    jinit, jupdate = jcomp.with_error_feedback_compression(
        jax_make_optimizer("adamw", 1e-2))

    def tp():
        return {k: torch.from_numpy(v.copy()) for k, v in p0.items()}

    fp, fs = tp(), init(tp())
    ip, ist = tp(), init(tp())
    jp, js = p0, jinit(p0)
    assert set(fs.inner) == {"base", "ef"}
    for i, g in enumerate(gs):
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        fp, fs = update(tg, fs, fp)
        ok = torch.tensor(True)
        ip, ist = update.guarded_in_place(tg, ist, ip, ok)
        jp, js = jupdate(g, js, jp)
        for a, b in zip(tree_leaves((ip, ist)), tree_leaves((fp, fs))):
            assert torch.equal(a, b)
        for k in p0:
            np.testing.assert_allclose(ip[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ist.inner["ef"][k].numpy(),
                                       np.asarray(js.inner["ef"][k]),
                                       rtol=1e-5, atol=1e-7)
    before = [t.clone() for t in tree_leaves((ip, ist))]
    ip, ist = update.guarded_in_place(
        {k: torch.from_numpy(v) for k, v in gs[0].items()}, ist, ip,
        torch.tensor(False))
    for a, b in zip(tree_leaves((ip, ist)), before):
        assert torch.equal(a, b)  # a skipped step keeps the residual too


def test_compressed_train_step_matches_reference():
    """Three ``ce_fused_linear`` steps with ``grad_compression="int8"``:
    loss and grad norm within 1e-5 of the reference's step."""
    loss = "ce_fused_linear"
    jarch = dataclasses.replace(jax_get_arch("sasrec-sce"), train_loss=loss)
    arch = dataclasses.replace(get_arch("sasrec-sce"), train_loss=loss)
    jcfg, cfg = jarch.make_smoke_config(), arch.make_smoke_config()
    guard.set_policy("off")
    try:
        jstep, (jinit, _), _ = jax_steps.make_seqrec_train_step(
            jarch, jcfg, None, JaxShapeSpec("train_smoke", "train",
                                            {"batch": 4}),
            grad_compression="int8")
        jstep = jax.jit(jstep)
        tstep, (tinit, _), _ = steps.make_seqrec_train_step(
            arch, cfg, ShapeSpec("train_smoke", "train", {"batch": 4}),
            grad_compression="int8")
        jp = jax_sasrec.init_params(jax.random.PRNGKey(0), jcfg)
        js = jinit(jp)
        tp = sasrec_params_from_jax(jax.tree.map(np.array, jp), device="cpu")
        ts = tinit(tp)
        data = SequenceDataset(SeqDataConfig(
            n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=4))
        cur = Cursor(seed=0)
        for i in range(3):
            batch, cur = data.next_batch(cur)
            jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch),
                               jax.random.PRNGKey(100 + i))
            tp, ts, tm = tstep(tp, ts, train.to_device(batch, "cpu"))
            assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                      rel=1e-5)
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=1e-5)
        np.testing.assert_allclose(
            ts.inner["ef"]["item_emb"].numpy(),
            np.asarray(js.inner["ef"]["item_emb"]), atol=1e-6)
    finally:
        guard.set_policy(None)
    with pytest.raises(ValueError, match="grad_compression"):
        steps.make_seqrec_train_step(arch, cfg, ShapeSpec(
            "train_smoke", "train", {"batch": 4}), grad_compression="fp8")


def test_compressed_run_resumes_bit_for_bit(tmp_path):
    """4 steps against 2 + a resumed 2: every loss, and the last
    checkpoint's leaves (params, AdamW moments, the residual, the
    generator and the cursor), bit for bit."""
    kw = dict(batch=4, device="cpu", log_every=0, grad_compression="int8",
              ckpt_every=2)
    whole = train.train("sasrec-sce", steps=4, ckpt_dir=str(tmp_path / "a"),
                        **kw)
    train.train("sasrec-sce", steps=2, ckpt_dir=str(tmp_path / "b"), **kw)
    rest = train.train("sasrec-sce", steps=4, ckpt_dir=str(tmp_path / "b"),
                       **kw)
    assert rest["steps"] == 2 and rest["losses"] == whole["losses"][2:]
    (sa, ta), (sb, tb) = (CheckpointManager(str(tmp_path / d)).restore_latest()
                          for d in "ab")
    assert sa == sb == 3
    assert set(ta["opt_state"][1]) == {"base", "ef"}  # OptState.inner
    la, lb = tree_leaves(ta), tree_leaves(tb)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# --n-hosts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_host_batch_matches_reference(n_hosts):
    cfg = get_arch("sasrec-sce").make_smoke_config()
    jarch = jax_get_arch("sasrec-sce")
    jcfg = jarch.make_smoke_config()
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=8))
    jdata = JaxSequenceDataset(JaxSeqDataConfig(
        n_items=jcfg.n_items, seq_len=jcfg.max_len, batch_size=8))
    shape = JaxShapeSpec("train_smoke", "train", {"batch": 8})
    got, cur = train._host_batch(data, Cursor(seed=3, step=2), n_hosts)
    want, jcur = jax_train._host_batch(jarch, jdata,
                                       JaxCursor(seed=3, step=2), shape,
                                       jcfg, n_hosts)
    one, _ = train._host_batch(data, Cursor(seed=3, step=2))
    assert set(got) == set(want) == set(one)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(got[k], one[k])
    assert (cur.seed, cur.step) == (jcur.seed, jcur.step) == (3, 3)


def test_train_takes_n_hosts_and_grad_compression(monkeypatch, capsys):
    with pytest.raises(ValueError, match="n_hosts"):
        train.train("sasrec-sce", steps=1, batch=4, n_hosts=3, device="cpu")
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "sasrec-sce", "--steps", "2", "--batch", "4",
        "--device", "cpu", "--grad-compression", "int8", "--n-hosts", "4"])
    train.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = train.train("sasrec-sce", steps=2, batch=4, device="cpu",
                       grad_compression="int8")
    assert out["losses"] == want["losses"]
    state = train.TrainState(params=None, opt_state=None,
                             generator=torch.Generator(),
                             cursor=Cursor(seed=0), step=0)
    assert state.to_ckpt(n_hosts=4)["cursor"]["n_hosts"] == 4
