"""Fault-tolerant checkpointing (port of ``repro/checkpoint/manager.py``).

Guarantees, the reference's:
  * **atomicity** — state is written to ``step_N.tmp`` and renamed to
    ``step_N`` only when complete; a crash mid-write never corrupts the
    latest valid checkpoint, and a stray ``.tmp`` from a previous crash
    is ignored on restore and overwritten by the next save of its step.
  * **integrity** — every checkpoint carries a ``manifest.json``
    (``format`` 1, ``step``, ``n_leaves``, and per file its ``bytes`` and
    ``crc32``), written and fsynced *before* the rename. ``restore``
    verifies it by default: a truncated ``leaves.npz``, a flipped
    manifest byte or a missing file raises :class:`CheckpointCorruptError`.
  * **fallback ladder** — ``restore_latest`` walks the steps newest to
    oldest and returns the newest one that passes verification, warning
    about (and skipping) corrupt ones; ``(None, None)`` only when no
    intact checkpoint exists. It never returns unverified bytes.
  * **keep-N** — older checkpoints are pruned after each save; the step
    just written is never pruned, even when ``keep_n`` shrank across a
    restart.
  * **async** — ``save(..., blocking=False)`` copies every leaf to host
    memory on the calling thread (the only part the caller waits for),
    then writes on a daemon thread; ``wait()`` joins it and re-raises
    its error. A ``kill -9`` mid-write leaves only an ignored ``.tmp``.
  * **save policy** — ``should_save(step)`` is due on a step interval
    (``save_every_steps``) or a wall-clock interval
    (``save_interval_seconds``), whichever fires first.

Format, the reference's with one file replaced: ``leaves.npz`` holds the
leaves as ``leaf_i`` in the order of ``optim.optimizers.tree_leaves``
(sorted dict keys, then sequence and NamedTuple items in order: the
order of ``jax.tree.leaves``, so leaf i of a port checkpoint and leaf i
of a reference checkpoint of the same state are the same array).
``treedef.json`` describes the tree in JSON (dict keys, sequence arity,
NamedTuple names and fields, each leaf's kind) in place of the
reference's pickled ``treedef.pkl``, which only JAX can read. Restore
parses JSON and loads the ``.npz`` with ``allow_pickle=False``: it
executes no bytes from disk. A step directory that holds ``treedef.pkl``
was written by the JAX package: it is not a port checkpoint, and
``all_steps`` skips it (``models/convert.py`` carries its params
across).

Leaves: tensors (any device) and numpy arrays come back as numpy arrays,
or as tensors on ``device=`` when it is given (the counterpart of the
reference's ``shardings``); Python ``int`` / ``float`` / ``bool`` leaves
come back as Python scalars. A dtype numpy cannot hold (``bfloat16``,
the float8 types, object arrays) raises ``TypeError`` at save.

Drill hook: ``REPRO_CKPT_WRITE_DELAY_S`` sleeps that many seconds after
the files are written but *before* the rename, so a ``kill -9`` can land
mid-write deterministically.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import sys
import threading
import time
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = 1
TREEDEF_NAME = "treedef.json"
# What the JAX package writes in place of treedef.json.
FOREIGN_TREEDEF = "treedef.pkl"
_CKPT_FILES = ("leaves.npz", TREEDEF_NAME)

# Tensor dtypes numpy holds; every other one (bfloat16, the float8
# types, ...) raises at save.
_NUMPY_DTYPES = {
    torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
    torch.int64, torch.float16, torch.float32, torch.float64,
    torch.complex64, torch.complex128,
}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification (missing, truncated or
    bit-flipped files, or an undecodable payload). ``restore_latest``
    catches it and falls back; a direct ``restore(step)`` raises it."""


# ---------------------------------------------------------------------------
# The tree's structure as JSON
# ---------------------------------------------------------------------------
def _flatten(tree, leaves: list) -> dict:
    """The JSON node of ``tree``; its leaves are appended to ``leaves``
    in the order of ``optim.optimizers.tree_leaves``."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        if not all(isinstance(k, str) for k in keys):
            raise TypeError(f"checkpoint dict keys must be str, got {keys}")
        return {"kind": "dict", "keys": keys,
                "children": [_flatten(tree[k], leaves) for k in keys]}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"kind": "namedtuple", "name": type(tree).__name__,
                "fields": list(tree._fields),
                "children": [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, (tuple, list)):
        return {"kind": type(tree).__name__,
                "children": [_flatten(v, leaves) for v in tree]}
    if tree is None:
        return {"kind": "none"}
    leaves.append(tree)
    return {"kind": "leaf", "leaf": _leaf_kind(tree)}


def _leaf_kind(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return "tensor"
    if isinstance(leaf, (np.ndarray, np.generic)):
        return "array"
    for kind in (bool, int, float):  # bool first: it is an int
        if isinstance(leaf, kind):
            return kind.__name__
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _to_host(leaf) -> np.ndarray:
    """A private host copy of one leaf: a CPU tensor's ``.cpu()`` is the
    same storage, so every tensor is copied."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NUMPY_DTYPES:
            raise TypeError(f"cannot checkpoint a {leaf.dtype} tensor: numpy "
                            f"has no such dtype")
        return leaf.detach().to("cpu", copy=True).numpy()
    arr = np.array(leaf, copy=True)
    if arr.dtype.kind not in "biufc":
        raise TypeError(f"cannot checkpoint a numpy array of dtype "
                        f"{arr.dtype}")
    return arr


def _count_leaves(node) -> int:
    if node.get("kind") == "leaf":
        return 1
    return sum(_count_leaves(c) for c in node.get("children", ()))


def _unflatten(node, leaves):
    """Rebuild the host tree of ``node`` from the iterator ``leaves``.
    NamedTuples come back as plain tuples (``TrainState.from_ckpt``
    rebuilds the optimizer state on a template)."""
    kind = node["kind"]
    if kind == "dict":
        return {k: _unflatten(c, leaves)
                for k, c in zip(node["keys"], node["children"], strict=True)}
    if kind in ("namedtuple", "tuple"):
        return tuple(_unflatten(c, leaves) for c in node["children"])
    if kind == "list":
        return [_unflatten(c, leaves) for c in node["children"]]
    if kind == "none":
        return None
    if kind != "leaf":
        raise ValueError(f"unknown node kind {kind!r}")
    arr = next(leaves)
    leaf = node["leaf"]
    if leaf in ("bool", "int", "float"):
        return {"bool": bool, "int": int, "float": float}[leaf](arr)
    if leaf not in ("tensor", "array"):
        raise ValueError(f"unknown leaf kind {leaf!r}")
    return arr


def _place(tree, device):
    """Array leaves of a restored host tree as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_place(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    return tree


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------
def _crc32_file(path: str, chunk: int = 1 << 20) -> str:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _warn(msg: str) -> None:
    print(f"[ckpt] WARNING: {msg}", file=sys.stderr)


class CheckpointManager:
    """Saves and restores step directories under ``directory``.

    ``last_snapshot_s`` / ``last_write_s`` hold the host seconds of the
    last save's copy to host memory (what a non-blocking save blocks
    for) and of its file writing (the writer thread's time, set when it
    finishes)."""

    def __init__(self, directory: str, *, keep_n: int = 3,
                 save_every_steps: Optional[int] = None,
                 save_interval_seconds: Optional[float] = None,
                 _clock=time.monotonic):
        self.directory = directory
        self.keep_n = keep_n
        self.save_every_steps = save_every_steps
        self.save_interval_seconds = save_interval_seconds
        os.makedirs(directory, exist_ok=True)
        self._clock = _clock
        self._last_save_t = _clock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # Restores that bypassed verification (``restore(verify=False)``);
        # the trainer's and the server's paths keep it at 0.
        self.unverified_loads = 0
        self.last_snapshot_s: Optional[float] = None
        self.last_write_s: Optional[float] = None

    # -- save policy -------------------------------------------------------
    def should_save(self, step: int) -> bool:
        """Due when ``step + 1`` is a multiple of ``save_every_steps`` OR
        ``save_interval_seconds`` of wall clock passed since the last
        save, whichever fires first; with neither set, never due."""
        if self.save_every_steps and (step + 1) % self.save_every_steps == 0:
            return True
        return (self.save_interval_seconds is not None
                and self._clock() - self._last_save_t
                >= self.save_interval_seconds)

    # -- write -------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        """Checkpoint ``tree`` at ``step``. The leaves are copied to host
        memory before this returns; a non-blocking save writes them on a
        background thread."""
        self.wait()  # one writer at a time; raises a prior writer's error
        t0 = time.perf_counter()
        leaves: list = []
        structure = _flatten(tree, leaves)
        host_leaves = [_to_host(x) for x in leaves]
        self.last_snapshot_s = time.perf_counter() - t0
        self._last_save_t = self._clock()

        def write():
            t1 = time.perf_counter()
            tmp = os.path.join(self.directory, f"step_{step}.tmp")
            final = os.path.join(self.directory, f"step_{step}")
            if os.path.exists(tmp):  # a stray dir from a crashed writer
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "leaves.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
            with open(os.path.join(tmp, TREEDEF_NAME), "w") as f:
                json.dump({"format": MANIFEST_FORMAT, "tree": structure}, f)
            # The manifest last, before the rename: its checksums cover
            # the payload, so later truncation or bit rot is detected.
            manifest = {"format": MANIFEST_FORMAT, "step": int(step),
                        "n_leaves": len(host_leaves), "files": {}}
            for name in _CKPT_FILES:
                p = os.path.join(tmp, name)
                manifest["files"][name] = {"bytes": os.path.getsize(p),
                                           "crc32": _crc32_file(p)}
            with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            delay = os.environ.get("REPRO_CKPT_WRITE_DELAY_S")
            if delay:  # drill hook: widen the mid-write kill window
                time.sleep(float(delay))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # the atomic commit point
            _fsync_dir(self.directory)
            self._prune(protect=step)
            self.last_write_s = time.perf_counter() - t1

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=self._guard(write),
                                            daemon=True)
            self._thread.start()

    def _guard(self, fn):
        def run():
            try:
                fn()
            except BaseException as e:  # raised by the next save()/wait()
                self._error = e

        return run

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self, *, protect: Optional[int] = None) -> None:
        """Remove all but the newest ``keep_n`` steps (0 keeps all);
        ``protect``, the step just written, always survives."""
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_n] if self.keep_n else []:
            if s == protect:
                continue
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"))

    # -- read --------------------------------------------------------------
    def _step_dirs(self):
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                yield int(m.group(1)), os.path.join(self.directory, name)

    def all_steps(self) -> List[int]:
        """Steps whose directories hold every file of a port checkpoint
        (payload, structure, manifest). Torn copies, partial deletes,
        stray ``.tmp`` dirs and the JAX package's checkpoints are
        skipped; checksums are verified at restore."""
        return sorted(
            s for s, d in self._step_dirs()
            if all(os.path.isfile(os.path.join(d, f))
                   for f in _CKPT_FILES + (MANIFEST_NAME,)))

    def foreign_steps(self) -> List[int]:
        """Steps whose directories hold the JAX package's pickled
        ``treedef.pkl``: checkpoints of the reference, not of the port."""
        return sorted(s for s, d in self._step_dirs()
                      if os.path.isfile(os.path.join(d, FOREIGN_TREEDEF)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify(self, step: int) -> dict:
        """Check ``step``'s manifest: parseable, the right step, every
        file present with its size and CRC32. Returns the manifest;
        raises :class:`CheckpointCorruptError` with the reason."""
        path = os.path.join(self.directory, f"step_{step}")

        def bad(reason):
            raise CheckpointCorruptError(f"step {step}: {reason}")

        man_path = os.path.join(path, MANIFEST_NAME)
        if not os.path.isfile(man_path):
            bad("missing manifest.json")
        try:
            with open(man_path) as f:
                manifest = json.load(f)
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            bad(f"unreadable manifest ({e})")
        if not isinstance(manifest, dict):
            bad("unreadable manifest (not an object)")
        if manifest.get("format") != MANIFEST_FORMAT:
            bad(f"unknown manifest format {manifest.get('format')!r}")
        if manifest.get("step") != step:
            bad(f"manifest claims step {manifest.get('step')!r}")
        files = manifest.get("files")
        if not isinstance(files, dict) or set(files) != set(_CKPT_FILES):
            bad(f"manifest file list {sorted(files or ())} != "
                f"{sorted(_CKPT_FILES)}")
        for name, meta in files.items():
            p = os.path.join(path, name)
            if not os.path.isfile(p):
                bad(f"missing {name}")
            size = os.path.getsize(p)
            if size != meta.get("bytes"):
                bad(f"{name}: {size} bytes, manifest says "
                    f"{meta.get('bytes')}")
            crc = _crc32_file(p)
            if crc != meta.get("crc32"):
                bad(f"{name}: crc32 {crc} != manifest {meta.get('crc32')}")
        return manifest

    def restore(self, step: int, *, device=None, verify: bool = True) -> Any:
        """Load the checkpoint at ``step``: array leaves as host numpy, or
        as tensors on ``device`` when it is given. Verification is on by
        default; ``verify=False`` is for debugging only and is counted in
        ``unverified_loads``."""
        if verify:
            manifest = self.verify(step)
        else:
            manifest = None
            self.unverified_loads += 1
        path = os.path.join(self.directory, f"step_{step}")
        try:
            with open(os.path.join(path, TREEDEF_NAME)) as f:
                structure = json.load(f)
            if structure.get("format") != MANIFEST_FORMAT:
                raise ValueError(f"unknown structure format "
                                 f"{structure.get('format')!r}")
            with np.load(os.path.join(path, "leaves.npz"),
                         allow_pickle=False) as z:
                leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
            n_tree = _count_leaves(structure["tree"])
            if n_tree != len(leaves):
                raise ValueError(f"{len(leaves)} leaves, the structure "
                                 f"holds {n_tree}")
            tree = _unflatten(structure["tree"], iter(leaves))
        except Exception as e:
            # Checksums passed but decoding failed (or verify was off):
            # corruption, so the fallback ladder can act.
            raise CheckpointCorruptError(
                f"step {step}: undecodable payload ({e})") from e
        if manifest is not None and len(leaves) != manifest["n_leaves"]:
            raise CheckpointCorruptError(
                f"step {step}: {len(leaves)} leaves, manifest says "
                f"{manifest['n_leaves']}")
        return tree if device is None else _place(tree, device)

    def restore_latest(self, *, device=None):
        """``(step, tree)`` of the newest checkpoint that passes
        verification — the fallback ladder. Corrupt or torn steps are
        warned about and skipped, never loaded; ``(None, None)`` when no
        step survives."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, device=device)
            except CheckpointCorruptError as e:
                _warn(f"{e} — falling back to the previous step")
        return None, None

    def restore_params(self, step: int, *, key: str = "params", device=None,
                       verify: bool = True) -> Any:
        """Load one top-level subtree of a checkpointed train-state dict
        (the server needs the params, not the optimizer state, generator
        or cursor, and only the subtree is placed on ``device``); the
        whole tree when the checkpoint has no ``key`` entry."""
        tree = self.restore(step, verify=verify)  # host numpy
        sub = tree[key] if isinstance(tree, dict) and key in tree else tree
        return sub if device is None else _place(sub, device)

    def restore_params_latest(self, *, key: str = "params", device=None):
        """``(step, params)``, or ``(None, None)`` with no intact
        checkpoint: ``restore_latest``'s ladder on the param subtree (the
        retrieval server's load path)."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore_params(step, key=key,
                                                 device=device)
            except CheckpointCorruptError as e:
                _warn(f"{e} — falling back to the previous step")
        return None, None
