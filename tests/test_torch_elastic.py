"""The port's fault tolerance on the CPU (ported from
``tests/test_elastic.py`` and ``tests/test_fault_tolerance.py``).

In process: ``TrainState`` round-trips through a checkpoint with the
generator's next draws; ``train(8)`` equals ``train(4)`` and a resumed
``train(8)`` bit for bit (every loss, and every leaf of the last
checkpoint, the generator's state included); SIGTERM drains (the
in-flight step completes, a final blocking save, ``preempted``); the
divergence drill rolls back to the last verified checkpoint; the
straggler watchdog reuses a batch and reads a bounded window of step
times; ``metrics_file``'s rows; the guards on ``ckpt_dir`` (a world > 1,
the server's refusals) and the server on a checkpoint.

The subprocess drills run the real CLI (``python -m
repro_torch.launch.train``), kill it (``kill -9`` mid-run, ``kill -9``
inside an async write held open by ``REPRO_CKPT_WRITE_DELAY_S``,
SIGTERM, which exits 42) and relaunch it with the same command line: the
loss curve must equal the uninterrupted run's step for step, bit for bit.
"""
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.data import Cursor
from repro_torch.kernels import guard as kguard
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.elastic import (
    EXIT_PREEMPTED,
    PreemptionHandler,
    TrainState,
)
from repro_torch.launch.serve import RetrievalServer
from repro_torch.optim.optimizers import adamw, tree_leaves

KW = dict(batch=4, seed=0, log_every=0, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke model's ops are tiny: one intra-op thread runs them as
    fast as eight on an idle host and far faster on a loaded one (the
    test workers share the cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _guard_policy_reset():
    yield
    kguard.set_policy(None)


def _curve(path):
    """step → loss, the last row of a step winning (a relaunch re-runs
    the steps between its checkpoint and the kill)."""
    out = {}
    for line in open(path):
        r = json.loads(line)
        out[r["step"]] = r["loss"]
    return out


def _leaves(ckpt_dir, step):
    with np.load(os.path.join(ckpt_dir, f"step_{step}", "leaves.npz")) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


# ---------------------------------------------------------------------------
# TrainState
# ---------------------------------------------------------------------------
def test_train_state_round_trips_with_the_generator(tmp_path):
    opt_init, opt_update = adamw(1e-3)
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": torch.ones(3)}
    grads = {"w": torch.full((2, 3), 0.5), "b": torch.ones(3)}
    params, opt_state = opt_update(grads, opt_init(params), params)
    gen = torch.Generator().manual_seed(9)
    torch.randn(7, generator=gen)  # the state is mid-stream
    state = TrainState(params=params, opt_state=opt_state, generator=gen,
                       cursor=Cursor(seed=5, step=11), step=11)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(11, state.to_ckpt())
    step, tree = mgr.restore_latest()
    assert step == 11
    # The topology is recorded (host 0 of 1) as ShardedCursor's state.
    assert (tree["cursor"]["host_id"], tree["cursor"]["n_hosts"]) == (0, 1)
    assert tree["key"].dtype == np.uint8
    back = TrainState.from_ckpt(tree, opt_template=opt_init(params))
    assert back.step == 11 and back.cursor == Cursor(seed=5, step=11)
    for k in params:
        assert torch.equal(back.params[k], params[k])
    assert type(back.opt_state) is type(opt_state)
    assert back.opt_state.step.dtype == torch.int32
    for a, b in zip(tree_leaves(back.opt_state), tree_leaves(opt_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(torch.randn(5, generator=back.generator),
                       torch.randn(5, generator=gen))
    p0, _ = opt_update(grads, opt_state, params)
    p1, _ = opt_update(grads, back.opt_state, back.params)
    for k in p0:
        assert torch.equal(p0[k], p1[k])
    on = TrainState.from_ckpt(mgr.restore(11, device="cpu"),
                              opt_template=opt_init(params))
    assert torch.equal(on.params["w"], params["w"])


def test_preemption_handler_installs_on_the_main_thread_only():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler() as h:
        assert signal.getsignal(signal.SIGTERM) == h._handle
        assert not h.preempted
    assert signal.getsignal(signal.SIGTERM) == before
    seen = {}

    def other():
        with PreemptionHandler() as h2:
            seen["installed"] = bool(h2._prev)

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen == {"installed": False}


# ---------------------------------------------------------------------------
# The trainer in process
# ---------------------------------------------------------------------------
def test_resume_equals_an_uninterrupted_run_bit_for_bit(tmp_path, capsys,
                                                        monkeypatch):
    verified = []
    restore = manager_mod.CheckpointManager.restore

    def recording(self, step, **kw):
        verified.append(kw.get("verify", True))
        return restore(self, step, **kw)

    monkeypatch.setattr(manager_mod.CheckpointManager, "restore", recording)
    kw = dict(KW, seed=3, ckpt_every=2, keep_n=0)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    straight = train_mod.train("sasrec-sce", steps=8, ckpt_dir=a, **kw)
    first = train_mod.train("sasrec-sce", steps=4, ckpt_dir=b, **kw)
    assert "resumed" not in capsys.readouterr().out
    resumed = train_mod.train("sasrec-sce", steps=8, ckpt_dir=b, **kw)
    assert "[restore] resumed from step 3" in capsys.readouterr().out
    assert first["losses"] == straight["losses"][:4]
    assert resumed["steps"] == 4
    assert resumed["losses"] == straight["losses"][4:]
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == [
        "step_1", "step_3", "step_5", "step_7"]
    for x, y in zip(_leaves(a, 7), _leaves(b, 7)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)  # params, AdamW, generator
    assert verified and all(verified)  # unverified_loads stays 0


def test_sigterm_drains_and_the_relaunch_continues(tmp_path):
    """SIGTERM at step 3's ``"start"`` mark: step 3 is in flight, so it
    completes, the loop stops before step 4 and a final blocking save
    keeps step 3; the relaunch resumes from it on the straight curve."""
    assert threading.current_thread() is threading.main_thread()
    metrics = tmp_path / "m.jsonl"
    starts = []

    def mark(name):
        if name == "start":
            starts.append(name)
            if len(starts) == 4:
                os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    kw = dict(KW, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=1000,
              metrics_file=str(metrics))
    out = train_mod.train("sasrec-sce", steps=10, mark=mark, **kw)
    assert signal.getsignal(signal.SIGTERM) == before
    assert out["preempted"] and out["preempt_step"] == 3
    assert out["steps"] == 4
    assert CheckpointManager(kw["ckpt_dir"]).all_steps() == [3]
    out2 = train_mod.train("sasrec-sce", steps=10, **kw)
    assert not out2.get("preempted") and out2["steps"] == 6
    ref = tmp_path / "ref.jsonl"
    train_mod.train("sasrec-sce", steps=10, metrics_file=str(ref), **KW)
    assert len(open(metrics).readlines()) == 10  # no step lost or re-run
    assert _curve(metrics) == _curve(ref)


@pytest.mark.parametrize("chaos_at,every,strikes,last", [
    (7, 3, 2, 5),  # the reference's drill
    (5, 4, 3, 3),  # the card's drill
])
def test_divergence_rolls_back_to_the_last_verified_checkpoint(
        tmp_path, capsys, chaos_at, every, strikes, last):
    ckpt = str(tmp_path / "ckpt")
    out = train_mod.train("sasrec-sce", steps=16, ckpt_dir=ckpt,
                          ckpt_every=every, keep_n=0, max_strikes=strikes,
                          chaos_nan_at=chaos_at, guard_policy="strict", **KW)
    assert out["rollbacks"] == 1
    assert out["skipped_steps"] == strikes
    rolled = chaos_at + strikes - 1
    assert out["steps"] == (rolled + 1) + (16 - last - 1)  # re-ran a stretch
    assert np.isfinite(out["final_loss"])
    lines = capsys.readouterr().out.splitlines()
    assert f"[guard] rolled back to verified step {last} (rollback #1, " \
           f"data offset +13)" in lines
    assert sum(ln.startswith(f"[chaos] step {chaos_at}") for ln in lines) == 1
    mgr = CheckpointManager(ckpt)
    for s in mgr.all_steps():  # no NaN ever reached a checkpoint
        assert all(np.isfinite(x).all() for x in tree_leaves(
            mgr.restore_params(s)))


def test_a_rollback_with_no_intact_checkpoint_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no intact checkpoint"):
        train_mod.train("sasrec-sce", steps=8, ckpt_dir=str(tmp_path),
                        ckpt_every=1000, max_strikes=2, chaos_nan_at=1,
                        **KW)


def test_straggler_watchdog_reuses_the_previous_batch(monkeypatch, capsys):
    real = train_mod._host_batch
    loads, t_first = [], []
    watchdog = 3.0

    def slow_fourth(data, cursor, n_hosts=1):
        loads.append(cursor.step)
        t_first.append(time.perf_counter())
        if len(loads) == 4:
            # A straggling input shard: longer than watchdog × all three
            # steps so far, so above watchdog × their median however
            # loaded the host is.
            time.sleep(watchdog * (t_first[-1] - t_first[0]) + 0.05)
        return real(data, cursor, n_hosts)

    monkeypatch.setattr(train_mod, "_host_batch", slow_fourth)
    out = train_mod.train("sasrec-sce", steps=6, skip_stragglers=True,
                          watchdog=watchdog, **KW)
    assert out["steps"] == 6 and np.isfinite(out["final_loss"])
    assert "[watchdog] step 3: slow input shard" in capsys.readouterr().out
    assert loads == [0, 1, 2, 3, 3, 4]  # the cursor did not advance


def test_straggler_watchdog_reads_a_bounded_window(monkeypatch):
    # One median a step, over at most WATCHDOG_WINDOW step times.
    seen = []

    def median(xs):
        seen.append(len(xs))
        return statistics.median(xs)

    monkeypatch.setattr(train_mod, "WATCHDOG_WINDOW", 3)
    monkeypatch.setattr(train_mod, "statistics", types.SimpleNamespace(
        median=median, mean=statistics.mean))
    out = train_mod.train("sasrec-sce", steps=6, skip_stragglers=True,
                          **KW)
    assert out["steps"] == 6 and len(out["step_s"]) == 6
    assert seen == [1, 2, 3, 3, 3, 3]


def test_metrics_file_rows(tmp_path):
    metrics = tmp_path / "m.jsonl"
    out = train_mod.train("sasrec-sce", steps=4, chaos_nan_at=2,
                          guard_policy="strict", metrics_file=str(metrics),
                          **KW)
    rows = [json.loads(line) for line in open(metrics)]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert [r["skipped"] for r in rows] == [False, False, True, True]
    np.testing.assert_array_equal([r["loss"] for r in rows], out["losses"])
    for r in rows[:2]:
        assert set(r) == {"step", "loss", "skipped", "grad_norm"}
        assert np.isfinite(r["grad_norm"])
    for r in rows[2:]:
        assert r["sentinels"] == {"sce_bucket_nonfinite": 1}


def test_checkpoints_under_a_world_of_several_processes_raise(
        monkeypatch, tmp_path):
    """Checkpoints under a world of several processes no longer raise:
    rank 0 writes, so rank 1 of 2 writes nothing, and reaches a barrier
    around each save (recorded here; the world's own runs are
    ``tests/test_torch_dist_train.py``'s)."""
    calls = []
    monkeypatch.setattr(train_mod, "world", lambda: (1, 2))
    monkeypatch.setattr(train_mod.dist, "barrier",
                        lambda: calls.append("barrier"))
    monkeypatch.setattr(train_mod.dist, "all_reduce",
                        lambda t, op=None: calls.append("agree"))
    monkeypatch.setattr(train_mod.dist, "broadcast",
                        lambda t, src: calls.append("lead"))
    out = train_mod.train("sasrec-sce", steps=2, ckpt_dir=str(tmp_path),
                          ckpt_every=2, **KW)
    assert out["steps"] == 2
    assert not list(tmp_path.iterdir())
    assert calls.count("barrier") == 2


# ---------------------------------------------------------------------------
# The server on a checkpoint
# ---------------------------------------------------------------------------
def test_server_serves_the_trainer_checkpoint(tmp_path, monkeypatch,
                                              capsys):
    ckpt = str(tmp_path / "ckpt")
    train_mod.train("sasrec-sce", steps=4, ckpt_dir=ckpt, ckpt_every=2,
                    **KW)
    kw = dict(buckets=(4, 8), top_k=5, device="cpu")
    srv = RetrievalServer("sasrec-sce", ckpt_dir=ckpt, **kw)
    step, params = CheckpointManager(ckpt).restore_params_latest(
        device="cpu")
    same = RetrievalServer("sasrec-sce", params=params, **kw)
    rand = RetrievalServer("sasrec-sce", **kw)
    try:
        assert srv.restored_step == step == 3
        assert same.restored_step is None
        hist = np.random.default_rng(0).integers(
            1, srv.cfg.n_items, size=(11, srv.cfg.max_len)).astype(np.int32)
        v, i = srv.score(hist)
        v2, i2 = same.score(hist)
        v3, i3 = rand.score(hist)
        np.testing.assert_array_equal(v, v2)
        np.testing.assert_array_equal(i, i2)
        assert not np.array_equal(i, i3)
    finally:
        for s in (srv, same, rand):
            s.close()
    monkeypatch.setattr("sys.argv", [
        "serve", "--requests", "5", "--buckets", "4,8", "--device", "cpu",
        "--ckpt-dir", ckpt])
    serve_mod.main()
    assert "params: checkpoint step 3" in capsys.readouterr().out


def test_server_refuses_an_empty_directory_and_params_with_ckpt_dir(
        tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint to serve"):
        RetrievalServer("sasrec-sce", ckpt_dir=str(tmp_path), device="cpu")
    (tmp_path / "step_4.tmp").mkdir()  # a torn write is not a checkpoint
    with pytest.raises(FileNotFoundError, match="no checkpoint to serve"):
        RetrievalServer("sasrec-sce", ckpt_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        RetrievalServer("sasrec-sce", ckpt_dir=str(tmp_path), params={},
                        device="cpu")


# ---------------------------------------------------------------------------
# Subprocess drills: the real CLI, killed and relaunched
# ---------------------------------------------------------------------------
_REPO = os.path.join(os.path.dirname(__file__), "..")
_DRILL_STEPS = 40
_DRILL_KW = ("--arch", "sasrec-sce", "--batch", "4", "--seed", "0",
             "--device", "cpu", "--log-every", "1000")


def _launch(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"),
               OMP_NUM_THREADS="1")  # as _one_thread, for every drill run
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *_DRILL_KW,
         *args], env=env, cwd=_REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _run_to_completion(*args):
    p = _launch(*args)
    out, err = p.communicate(timeout=240)
    assert p.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return out


def _rows(path):
    return sum(1 for _ in open(path)) if path.exists() else 0


def _kill_when(proc, predicate, sig=signal.SIGKILL, timeout=240.0):
    """Send ``sig`` as soon as ``predicate()`` holds; False when the
    process exited first."""
    deadline = time.monotonic() + timeout
    while not predicate() and proc.poll() is None:
        assert time.monotonic() < deadline, "the drill's moment never came"
        time.sleep(0.005)
    if proc.poll() is not None:
        return False
    os.kill(proc.pid, sig)
    proc.communicate(timeout=240)
    return True


@pytest.fixture(scope="module")
def straight_curve(tmp_path_factory):
    """The uninterrupted run every drill ends on."""
    d = tmp_path_factory.mktemp("straight")
    metrics = d / "m.jsonl"
    _run_to_completion("--steps", str(_DRILL_STEPS), "--ckpt-dir",
                       str(d / "ckpt"), "--ckpt-every", "1000",
                       "--metrics-file", str(metrics))
    curve = _curve(metrics)
    assert sorted(curve) == list(range(_DRILL_STEPS))
    return curve


def _assert_curves_equal(curve, ref, n_steps=_DRILL_STEPS):
    assert sorted(curve) == list(range(n_steps)), f"{len(curve)} steps"
    diffs = [s for s in range(n_steps) if curve[s] != ref[s]]
    assert not diffs, f"the curve left the straight one at steps {diffs[:5]}"


def test_kill9_mid_run_drill(tmp_path, straight_curve):
    metrics = tmp_path / "m.jsonl"
    args = ("--steps", str(_DRILL_STEPS), "--ckpt-dir",
            str(tmp_path / "ckpt"), "--ckpt-every", "3",
            "--metrics-file", str(metrics))
    p = _launch(*args)
    assert _kill_when(p, lambda: _rows(metrics) >= 12), \
        "the run finished before the kill landed"
    assert p.returncode == -signal.SIGKILL
    _run_to_completion(*args)
    _assert_curves_equal(_curve(metrics), straight_curve)


def test_kill9_mid_async_write_drill(tmp_path, straight_curve):
    """The kill lands inside an async write (held between the payload and
    the rename): the torn ``.tmp`` is ignored and later overwritten."""
    n = 24
    metrics = tmp_path / "m.jsonl"
    ckpt = tmp_path / "ckpt"
    args = ("--steps", str(n), "--ckpt-dir", str(ckpt), "--ckpt-every", "3",
            "--metrics-file", str(metrics))
    p = _launch(*args, env_extra={"REPRO_CKPT_WRITE_DELAY_S": "0.4"})
    assert _kill_when(p, lambda: ckpt.exists()
                      and any(ckpt.glob("step_*.tmp"))), \
        "no write window seen before the run finished"
    assert list(ckpt.glob("step_*.tmp")), "the kill did not land mid-write"
    _run_to_completion(*args)
    _assert_curves_equal(_curve(metrics), straight_curve, n_steps=n)
    assert not list(ckpt.glob("step_*.tmp"))


def test_sigterm_drill_exits_42_and_loses_no_step(tmp_path, straight_curve):
    metrics = tmp_path / "m.jsonl"
    args = ("--steps", str(_DRILL_STEPS), "--ckpt-dir",
            str(tmp_path / "ckpt"), "--ckpt-every", "1000",
            "--metrics-file", str(metrics))
    p = _launch(*args)
    assert _kill_when(p, lambda: _rows(metrics) >= 12, sig=signal.SIGTERM), \
        "the run finished before SIGTERM landed"
    assert p.returncode == EXIT_PREEMPTED
    done = _rows(metrics)
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [done - 1]
    out = _run_to_completion(*args)
    assert f"[restore] resumed from step {done - 1}" in out
    _assert_curves_equal(_curve(metrics), straight_curve)
    assert _rows(metrics) == _DRILL_STEPS  # the drain's save lost nothing
