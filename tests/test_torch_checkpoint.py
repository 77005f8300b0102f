"""The port's checkpoints against the JAX package's
(``repro_torch/checkpoint/manager.py`` against ``repro/checkpoint``).

Both managers see the same steps, clock readings, saves and corruptions
and must make the same decisions: ``should_save``, the steps ``keep_n``
keeps (the protected step included), the step ``restore_latest`` picks.
For the same SASRec params and AdamW state (carried across by
``models/convert.py``) the port's ``leaves.npz`` holds the reference's
leaves leaf for leaf, in dtype and value (equal bit for bit: nothing is
computed). ``ShardedCursor`` matches the reference's state contract. A
checkpoint written by the reference's trainer is restored by the
reference's manager and carried across; the port's server then answers
with the reference server's top-k ids wherever neighbouring scores are
further apart than ``1e-5·max|score|`` (the two forwards fold f32 sums
in another order), and the port's ``RetrievalServer(ckpt_dir=)`` refuses
the reference's directory, naming ``models/convert.py``.
"""
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointCorruptError as JaxCorruptError
from repro.checkpoint import CheckpointManager as JaxManager
from repro.data import Cursor as JaxCursor
from repro.data import ShardedCursor as JaxShardedCursor
from repro.data import shard_batch as jax_shard_batch
from repro_torch.checkpoint import CheckpointCorruptError, CheckpointManager
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.data import Cursor, ShardedCursor, shard_batch
from repro_torch.launch.serve import RetrievalServer
from repro_torch.models.convert import (
    adamw_state_from_jax,
    sasrec_params_from_jax,
)
from repro_torch.optim.optimizers import OptState, adamw, tree_leaves


def _tree(v=1.0):
    return {"w": np.full((4, 3), v, np.float32), "step": np.int64(7)}


def _both(tmp_path, **kw):
    """The reference's and the port's manager on sibling directories."""
    return (JaxManager(str(tmp_path / "ref"), **kw),
            CheckpointManager(str(tmp_path / "port"), **kw))


# ---------------------------------------------------------------------------
# Save policy and pruning
# ---------------------------------------------------------------------------
def test_should_save_decisions_match_reference(tmp_path):
    """One sequence of steps, clock readings and saves: the same
    decisions from both managers (step policy, wall-clock policy, the
    clock baseline reset by a save)."""
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    for every, interval in ((4, 60.0), (None, 10.0), (3, None),
                            (None, None)):
        t[0] = 0.0
        ref, port = _both(tmp_path / f"{every}_{interval}",
                          save_every_steps=every,
                          save_interval_seconds=interval, _clock=clock)
        rng = np.random.default_rng(0)
        got, want = [], []
        for step in range(40):
            t[0] += float(rng.uniform(0.0, 7.0))
            a, b = ref.should_save(step), port.should_save(step)
            want.append(a)
            got.append(b)
            if a and step % 3 == 0:  # saves reset the clock baseline
                ref.save(step, _tree(step))
                port.save(step, _tree(step))
        assert got == want
        assert any(want) == (every is not None or interval is not None)


def test_keep_n_prunes_the_same_steps_as_reference(tmp_path):
    ref, port = _both(tmp_path, keep_n=2)
    for s in (0, 1, 5, 3, 9):
        ref.save(s, _tree(s))
        port.save(s, _tree(s))
        assert port.all_steps() == ref.all_steps()
    assert port.all_steps() == [5, 9]


def test_protected_step_survives_a_shrunk_keep_n_as_in_reference(tmp_path):
    ref, port = _both(tmp_path, keep_n=0)
    for s in (0, 1, 2, 3):
        ref.save(s, _tree(s))
        port.save(s, _tree(s))
    ref = JaxManager(ref.directory, keep_n=1)
    port = CheckpointManager(port.directory, keep_n=1)
    ref.save(1, _tree(1.5))  # re-save an old step with keep_n=1
    port.save(1, _tree(1.5))
    assert port.all_steps() == ref.all_steps() == [1, 3]
    np.testing.assert_array_equal(port.restore(1)["w"], _tree(1.5)["w"])


# ---------------------------------------------------------------------------
# The fallback ladder
# ---------------------------------------------------------------------------
def _corrupt(d, how, structure):
    latest = d / "step_2"
    if how == "truncate_leaves":
        p = latest / "leaves.npz"
        p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    elif how == "flip_manifest":
        p = latest / "manifest.json"
        raw = bytearray(p.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        p.write_bytes(bytes(raw))
    elif how == "delete_leaves":
        (latest / "leaves.npz").unlink()
    elif how == "delete_structure":
        (latest / structure).unlink()
    elif how == "stray_tmp":
        stray = d / "step_3.tmp"
        stray.mkdir()
        (stray / "leaves.npz").write_bytes(b"half-written garbage")
    elif how == "all_corrupt":
        for s in (0, 1, 2):
            (d / f"step_{s}" / "leaves.npz").write_bytes(b"garbage")
    else:
        raise AssertionError(how)


@pytest.mark.parametrize("how,want", [
    ("truncate_leaves", 1), ("flip_manifest", 1), ("delete_leaves", 1),
    ("delete_structure", 1), ("stray_tmp", 2), ("all_corrupt", None),
])
def test_restore_latest_picks_the_reference_step(tmp_path, how, want,
                                                 capsys):
    ref, port = _both(tmp_path, keep_n=0)
    for s in (0, 1, 2):
        ref.save(s, _tree(float(s)))
        port.save(s, _tree(float(s)))
    _corrupt(tmp_path / "ref", how, "treedef.pkl")
    _corrupt(tmp_path / "port", how, "treedef.json")
    ref_step, ref_tree = ref.restore_latest()
    step, tree = port.restore_latest()
    assert step == ref_step == want
    if want is None:
        assert tree is None and ref_tree is None
    else:
        np.testing.assert_array_equal(tree["w"], ref_tree["w"])
        assert tree["step"] == ref_tree["step"]
    err = capsys.readouterr().err
    n_warn = {"truncate_leaves": 2, "flip_manifest": 2,
              "all_corrupt": 6}.get(how, 0)  # reference's, then port's
    assert err.count("falling back") == n_warn
    assert port.unverified_loads == 0
    if how in ("truncate_leaves", "flip_manifest"):
        with pytest.raises(CheckpointCorruptError):
            port.verify(2)
        with pytest.raises(JaxCorruptError):
            ref.verify(2)


def test_a_crc_valid_but_undecodable_payload_is_corruption(tmp_path):
    """A payload whose manifest was rewritten to match (so the CRC
    passes) but whose structure file lies is reported as corruption, not
    loaded."""
    mgr = CheckpointManager(str(tmp_path), keep_n=0)
    mgr.save(0, _tree(0.0))
    mgr.save(1, _tree(1.0))
    d = tmp_path / "step_1"
    (d / "treedef.json").write_text(json.dumps(
        {"format": 1, "tree": {"kind": "leaf", "leaf": "array"}}))
    man = json.loads((d / "manifest.json").read_text())
    man["files"]["treedef.json"] = {
        "bytes": (d / "treedef.json").stat().st_size,
        "crc32": manager_mod._crc32_file(str(d / "treedef.json"))}
    (d / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(CheckpointCorruptError, match="undecodable"):
        mgr.restore(1)
    assert mgr.restore_latest()[0] == 0


# ---------------------------------------------------------------------------
# The payload, leaf for leaf
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sasrec_state():
    """Smoke-config SASRec params and an AdamW state with nonzero
    moments, as the reference's trees of numpy arrays."""
    from repro.configs import get_arch as jax_get_arch
    from repro.models import sasrec as jax_sasrec
    from repro.optim.optimizers import OptState as JaxOptState

    cfg = jax_get_arch("sasrec-sce").make_smoke_config()
    params = jax.tree.map(
        np.asarray, jax_sasrec.init_params(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(3)
    moments = {k: jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) ** e,
        params) for k, e in (("m", 1), ("v", 2))}
    return params, JaxOptState(step=np.asarray(5, np.int32), inner=moments)


def test_payload_leaves_equal_the_reference_leaf_for_leaf(tmp_path,
                                                          sasrec_state):
    jparams, jopt = sasrec_state
    jstate = {"params": jparams, "opt_state": jopt,
              "cursor": JaxShardedCursor(JaxCursor(seed=5, step=11),
                                         n_hosts=1).to_state(),
              "step": 11}
    tstate = {"params": sasrec_params_from_jax(jparams, device="cpu"),
              "opt_state": adamw_state_from_jax(jopt, device="cpu"),
              "cursor": ShardedCursor(Cursor(seed=5, step=11),
                                      n_hosts=1).to_state(),
              "step": 11}
    ref, port = _both(tmp_path)
    ref.save(11, jstate)
    port.save(11, tstate)
    with np.load(tmp_path / "ref" / "step_11" / "leaves.npz") as z:
        want = [z[f"leaf_{i}"] for i in range(len(z.files))]
    with np.load(tmp_path / "port" / "step_11" / "leaves.npz") as z:
        got = [z[f"leaf_{i}"] for i in range(len(z.files))]
    assert len(got) == len(want) == len(jax.tree.leaves(jstate))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w)
    port_man = json.loads(
        (tmp_path / "port" / "step_11" / "manifest.json").read_text())
    ref_man = json.loads(
        (tmp_path / "ref" / "step_11" / "manifest.json").read_text())
    assert port_man["n_leaves"] == ref_man["n_leaves"]
    assert set(port_man["files"]) == {"leaves.npz", "treedef.json"}
    # The port's leaf order is its own tree_leaves, jax.tree.leaves' order.
    for g, t in zip(got, tree_leaves(tstate)):
        np.testing.assert_array_equal(
            g, t.numpy() if torch.is_tensor(t) else np.asarray(t))


def test_restore_rebuilds_the_tree_without_pickle(tmp_path):
    """The structure is JSON and the payload loads with
    ``allow_pickle=False``: no file holds a pickle, and the tree comes
    back with its keys, tuples, scalars and dtypes (NamedTuples as
    tuples; on ``device`` array leaves are tensors)."""
    params = {"b": torch.arange(3, dtype=torch.int32),
              "a": torch.ones(2, 2, dtype=torch.float64)}
    init, _ = adamw(1e-3)
    tree = {"params": params, "opt_state": init(params), "n": 4,
            "f": 0.5, "flag": True, "arr": np.arange(4, dtype=np.int16),
            "seq": [np.float32(1.0), None, (np.int8(2),)]}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, tree)
    d = tmp_path / "step_0"
    with zipfile.ZipFile(d / "leaves.npz") as z:
        for name in z.namelist():
            assert b"\x80" not in z.read(name)[:2]  # no pickle protocol
    assert not (d / "treedef.pkl").exists()
    back = mgr.restore(0)
    assert back["n"] == 4 and isinstance(back["n"], int)
    assert back["f"] == 0.5 and back["flag"] is True
    assert back["arr"].dtype == np.int16
    assert back["params"]["b"].dtype == np.int32
    step, inner = back["opt_state"]
    assert step.dtype == np.int32 and step.shape == ()
    np.testing.assert_array_equal(inner["m"]["a"], np.zeros((2, 2)))
    assert back["seq"][1] is None and back["seq"][2][0] == 2
    on = mgr.restore(0, device="cpu")
    assert torch.is_tensor(on["params"]["a"]) and on["n"] == 4
    assert isinstance(init(params), OptState)


def test_save_snapshots_on_the_calling_thread(tmp_path, monkeypatch):
    """``save(blocking=False)`` copies every leaf before the writer
    starts, CPU tensors included (their ``.cpu()`` is the same storage):
    writing into the tensors afterwards does not reach the file."""
    monkeypatch.setenv("REPRO_CKPT_WRITE_DELAY_S", "0.2")
    t = torch.zeros(1000)
    a = np.zeros(10)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"t": t, "a": a}, blocking=False)
    t.fill_(7.0)
    a.fill(7.0)
    assert mgr.last_snapshot_s is not None
    mgr.wait()
    back = mgr.restore(0)
    assert not back["t"].any() and not back["a"].any()
    assert mgr.last_write_s >= 0.2


def test_a_dtype_numpy_cannot_hold_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(0, {"w": torch.ones(2, dtype=torch.bfloat16)})
    with pytest.raises(TypeError):
        mgr.save(0, {"w": np.array(["a"], dtype=object)})
    assert mgr.all_steps() == []


def test_unverified_loads_counter(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _tree())
    mgr.restore(0)
    assert mgr.unverified_loads == 0
    mgr.restore(0, verify=False)
    assert mgr.unverified_loads == 1


def test_restore_params_latest_falls_back_to_the_params_subtree(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=0)
    for s in (0, 1):
        mgr.save(s, {"params": _tree(float(s)), "extra": np.int32(s)})
    (tmp_path / "step_1" / "leaves.npz").write_bytes(b"garbage")
    step, params = mgr.restore_params_latest(device="cpu")
    assert step == 0 and set(params) == {"w", "step"}
    assert torch.equal(params["w"], torch.zeros(4, 3))
    assert mgr.unverified_loads == 0


# ---------------------------------------------------------------------------
# ShardedCursor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,host_id,n_hosts", [
    (0, 0, 0, 1), (5, 11, 1, 4), (3, 7, 3, 4), (0x5EED, 2, 0, 2),
])
def test_sharded_cursor_state_matches_reference(seed, step, host_id,
                                                n_hosts):
    want = JaxShardedCursor(JaxCursor(seed, step), host_id=host_id,
                            n_hosts=n_hosts)
    got = ShardedCursor(Cursor(seed, step), host_id=host_id, n_hosts=n_hosts)
    assert got.to_state() == want.to_state()
    for h, n in ((0, 1), (1, 2)):  # restored onto the current topology
        a = ShardedCursor.from_state(got.to_state(), host_id=h, n_hosts=n)
        b = JaxShardedCursor.from_state(want.to_state(), host_id=h,
                                        n_hosts=n)
        assert a.to_state() == b.to_state()
    assert got.advance(3).to_state() == want.advance(3).to_state()
    assert got.split("eval").to_state() == want.split("eval").to_state()
    assert (got.resharded(0, 2).to_state()
            == want.resharded(0, 2).to_state())
    assert Cursor.from_state(got.to_state()) == Cursor(seed, step)
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3),
             "valid": np.ones((8, 3), bool)}
    for k, v in got.shard(batch).items():
        np.testing.assert_array_equal(v, want.shard(batch)[k])
        np.testing.assert_array_equal(
            v, jax_shard_batch(batch, host_id, n_hosts)[k])


def test_sharded_cursor_validation_matches_reference():
    batch = {"x": np.zeros((6, 2))}
    for fn in (shard_batch, jax_shard_batch):
        with pytest.raises(ValueError):
            fn(batch, 0, 4)  # 6 rows over 4 hosts
        with pytest.raises(ValueError):
            fn(batch, 2, 2)
    for cls, cur in ((ShardedCursor, Cursor(0)),
                     (JaxShardedCursor, JaxCursor(0))):
        with pytest.raises(ValueError):
            cls(cur, host_id=2, n_hosts=2)
        with pytest.raises(ValueError):
            cls(cur, n_hosts=0)


# ---------------------------------------------------------------------------
# A checkpoint of the reference's trainer, served by the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """4 steps of the reference trainer (``sasrec-sce``, CPU) with
    checkpoints at steps 1 and 3. ``gspmd``: the reference's default
    ``exact`` fails inside ``shard_map`` on this JAX (ROADMAP.md queue 3,
    known deviations)."""
    from repro.kernels import guard as jax_guard
    from repro.launch.train import train as jax_train

    d = tmp_path_factory.mktemp("ref_ckpt")
    jax_guard.set_policy("off")
    try:
        jax_train("sasrec-sce", steps=4, batch=2, ckpt_dir=str(d),
                  ckpt_every=2, log_every=100, sce_mode="gspmd")
    finally:
        jax_guard.set_policy(None)
    return d


def test_reference_checkpoint_served_by_the_port(ref_ckpt):
    from repro.launch.serve import RetrievalServer as JaxServer

    step, jparams = JaxManager(str(ref_ckpt)).restore_params_latest()
    assert step == 3
    jsrv = JaxServer("sasrec-sce", buckets=(8,), top_k=10,
                     ckpt_dir=str(ref_ckpt), defer_readiness=True)
    try:
        assert jsrv.restored_step == 3
        hist = np.random.default_rng(0).integers(
            1, jsrv.cfg.n_items, size=(10, jsrv.cfg.max_len)).astype(np.int32)
        wv, wi = jsrv.score(hist)
    finally:
        jsrv.close()
    srv = RetrievalServer("sasrec-sce", buckets=(8,), top_k=10,
                          params=sasrec_params_from_jax(jparams,
                                                        device="cpu"),
                          device="cpu")
    try:
        gv, gi = srv.score(hist)
    finally:
        srv.close()
    tol = 1e-5 * float(np.abs(wv).max())
    assert np.abs(gv - wv).max() <= tol
    prv = np.concatenate([np.full_like(wv[:, :1], np.inf), wv[:, :-1]], 1)
    nxt = np.concatenate([wv[:, 1:], np.full_like(wv[:, :1], -np.inf)], 1)
    isolated = ((prv - wv) > tol) & ((wv - nxt) > tol)
    assert isolated.mean() > 0.5
    np.testing.assert_array_equal(gi[isolated], wi[isolated])


def test_port_server_refuses_a_reference_checkpoint(ref_ckpt):
    assert CheckpointManager(str(ref_ckpt)).all_steps() == []
    assert CheckpointManager(str(ref_ckpt)).foreign_steps() == [1, 3]
    with pytest.raises(FileNotFoundError,
                       match=r"treedef\.pkl.*models/convert\.py"):
        RetrievalServer("sasrec-sce", ckpt_dir=str(ref_ckpt), device="cpu")
    assert sorted(os.listdir(ref_ckpt)) == ["step_1", "step_3"]
