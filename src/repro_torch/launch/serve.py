"""Retrieval server — MIPS top-k over the catalog on one H100, or on a
``(data, model)`` mesh (port of ``repro/launch/serve.py``).

Requests arrive as user histories on a bounded queue; a worker thread
drains them with continuous micro-batching into a static set of batch
shape buckets, and each micro-batch runs the serve step: the seqrec
arch's forward (SASRec, or BERT4Rec's bidirectional encoder for
``RetrievalServer("bert4rec")``), the last position's hidden state, then
the hand-written ``mips_topk``
kernel over the catalog (``kernels.ops.mips_topk`` via
``eval.streaming.streaming_topk``) — no ``(B, C)`` score matrix.

Dataflow::

    submit() ──▶ bounded queue ──▶ worker: pop ≤ max_bucket requests
                 │ (backpressure:      │
                 │  ServerOverloaded-  ▼
                 │  Error when full)  bucket router → pad_to_bucket
                                       │
                                       ▼
                     serve step for that bucket (forward → mips_topk)
                                       │
                                       ▼
                     unpad → per-request ServeResult (full top-k, or
                     the degraded-k prefix under overload / past the
                     request deadline — never a hang, never a drop)

Differences from the JAX server:

* ``cfg=`` selects the model configuration (default: the arch's smoke
  config, as the JAX server hard-wires); pass ``make_config()`` to serve
  at the paper's full width. This is the one change of interface.
* The step runs eagerly. The constructor warms each bucket once (which
  also builds the CUDA kernel on first use); ``compile_count`` counts
  warmed buckets and ``cache_misses`` counts shapes outside the bucket
  set, which the router never emits.
* Parameters come from ``ckpt_dir=`` (the newest verified checkpoint of
  the port's trainer, through ``CheckpointManager.restore_params_latest``;
  ``restored_step`` names it), from ``params=`` (the port's
  ``init_params`` or ``models.convert.sasrec_params_from_jax``), or from
  random init with ``seed``. A checkpoint the JAX package wrote is not
  the port's (its structure is a pickle only JAX reads): restore it with
  ``repro``'s manager and carry it across with
  ``models/convert.py::sasrec_params_from_jax``.
* ``mesh=`` (``dist/sharding.py::make_mesh``) serves on a mesh of
  ``torch.distributed`` ranks: the catalog on ``model``, the requests on
  the data axes (``steps.make_seqrec_mips_serve_step(mesh=)``), every
  bucket dividing the data axes (refused at construction otherwise). The
  ranks run one program together, as the reference's one controller
  drives its devices: every rank constructs the server and scores the
  same requests in the same order (``score()``), and each gets every
  answer. The async queue micro-batches by arrival, which differs from
  process to process, so over several processes serve through
  ``score()``.
* The readiness gate (``kernels/guard``) runs the ``mips_topk``
  conformance verdict on the server's device at construction, before
  the buckets are warmed (warming runs the kernel). A failed verdict
  leaves the server not ready with ``readiness_error`` set; then async
  submits AND the bulk ``score()`` raise ``ServerNotReadyError`` — the
  reference's bulk path would serve through its degraded ref program,
  a fallback from the card this port forbids. ``refresh_readiness()``
  re-runs the gate (after ``guard.clear_verdicts``) and warms the
  buckets once it passes; ``health()`` reports ``guard_policy`` and the
  whole verdict table.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec-sce \\
      --requests 64 --buckets 8,32 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch bert4rec \\
      --requests 11 --buckets 4,8 --device cpu
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
from repro_torch.dist.sharding import dp_size
from repro_torch.kernels import guard
from repro_torch.launch import steps as steps_lib
from repro_torch.models import sasrec as sasrec_lib


class ServerOverloadedError(RuntimeError):
    """Backpressure rejection: the bounded queue is full, the server is
    closed, or the serve worker failed mid-batch. The request was NOT
    served — explicitly, never silently dropped."""


class ServerNotReadyError(RuntimeError):
    """Readiness rejection: the server has not passed its conformance
    readiness gate (the ``mips_topk`` canaries on its device). Distinct
    from :class:`ServerOverloadedError` — a startup/health condition, not
    load; retrying without a fix and ``refresh_readiness`` will not
    help."""


# ---------------------------------------------------------------------------
# Shape-bucket padding
# ---------------------------------------------------------------------------
def pad_to_bucket(arr: np.ndarray, bucket: int, *, axis: int = 0) -> np.ndarray:
    """Zero-pad ``arr`` along ``axis`` up to exactly ``bucket`` rows.
    Raises ``ValueError`` when the rows don't fit (routing must split
    first)."""
    n = arr.shape[axis]
    if n > bucket:
        raise ValueError(
            f"{n} rows do not fit shape bucket {bucket}; split upstream"
        )
    if n == bucket:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, bucket - n)
    return np.pad(arr, widths)


def unpad(arr: np.ndarray, n: int, *, axis: int = 0) -> np.ndarray:
    """The first ``n`` rows along ``axis`` — the inverse of
    :func:`pad_to_bucket`. Raises ``ValueError`` when ``n`` exceeds what's
    there."""
    if n > arr.shape[axis]:
        raise ValueError(f"cannot unpad {n} rows from {arr.shape[axis]}")
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(0, n)
    return arr[tuple(idx)]


class BucketRouter:
    """Maps arbitrary request-arrival counts onto a static set of batch
    shape buckets, so the serving path only runs warmed shapes."""

    def __init__(self, buckets: Sequence[int]):
        bs = sorted({int(b) for b in buckets})
        if not bs or bs[0] <= 0:
            raise ValueError(f"need positive bucket sizes, got {buckets!r}")
        self.buckets: Tuple[int, ...] = tuple(bs)
        self.max_bucket: int = bs[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding ``n`` requests (1 ≤ n ≤ max_bucket)."""
        if not 0 < n <= self.max_bucket:
            raise ValueError(
                f"n={n} outside (0, {self.max_bucket}]; plan() splits"
            )
        return self.buckets[bisect.bisect_left(self.buckets, n)]

    def plan(self, n: int) -> List[Tuple[int, int]]:
        """Split ``n`` pending requests into ``(count, bucket)`` chunks:
        full ``max_bucket`` batches, then one right-sized tail bucket.
        ``plan(0) == []``."""
        out: List[Tuple[int, int]] = []
        while n > self.max_bucket:
            out.append((self.max_bucket, self.max_bucket))
            n -= self.max_bucket
        if n:
            out.append((n, self.bucket_for(n)))
        return out


# ---------------------------------------------------------------------------
# Requests / results
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServeResult:
    """One request's retrieval: ``k`` (item id, score) pairs, best first.
    ``degraded`` marks the smaller-k overload/deadline response (a prefix
    of the exact full top-k)."""

    ids: np.ndarray
    vals: np.ndarray
    degraded: bool
    k: int


class Request:
    """Handle returned by :meth:`RetrievalServer.submit`. ``result()``
    blocks until served, rejected (raises ``ServerOverloadedError``) or
    the caller-side ``timeout`` lapses (raises ``TimeoutError``)."""

    __slots__ = (
        "history", "deadline", "t_submit", "t_done",
        "_event", "_value", "_error",
    )

    def __init__(self, history: np.ndarray, deadline: Optional[float]):
        self.history = history
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.t_submit = time.monotonic()
        self.t_done: Optional[float] = None
        self._event = threading.Event()
        self._value: Optional[ServeResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_ms(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1e3

    def _finish(self, value: ServeResult) -> None:
        self.t_done = time.monotonic()
        self._value = value
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self.t_done = time.monotonic()
        self._error = err
        self._event.set()


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------
class RetrievalServer:
    """Async micro-batching retrieval server over the MIPS serve step.

    Parameters
    ----------
    arch_name : seqrec arch (``configs.get_arch``).
    cfg : model configuration; ``None`` = the arch's smoke config. Pass
        the arch's ``make_config()`` to serve at full width.
    buckets : static batch-shape bucket set; each is warmed once at
        construction (``compile_count``), and serving a shape outside the
        set increments ``cache_misses``.
    top_k / degraded_top_k : full and overload/deadline answer sizes
        (degraded defaults to ``max(1, top_k // 2)``); the degraded
        response is a prefix of the exact top-k.
    queue_size : bounded-queue capacity; ``submit`` past it raises
        ``ServerOverloadedError``. Backlog ≥ ``queue_size // 2`` flips
        responses to degraded-k.
    deadline_s : default per-request deadline (relative seconds);
        requests past it at serve time get the degraded-k response.
    ckpt_dir : load the params of the newest verified checkpoint there
        (``CheckpointManager.restore_params_latest``) and set
        ``restored_step``; raises ``FileNotFoundError`` when it holds no
        intact port checkpoint. Not together with ``params``.
    params : model parameters (``models.sasrec.init_params`` layout,
        BERT4Rec's [MASK] row included); ``None`` (and no ``ckpt_dir``)
        = random init from ``seed``.
    device : ``None`` = ``cuda`` (raises without one); ``"cpu"`` runs the
        plain kernel versions on the CPU.
    mesh : optional ``Mesh`` — catalog on ``"model"``, requests on the
        data axes (module docstring); every bucket must divide the data
        axes. ``None`` = one device.
    defer_readiness : skip the constructor's readiness gate; the server
        stays not ready (and cold) until ``refresh_readiness()`` passes.
    """

    def __init__(self, arch_name: str = "sasrec-sce", *, cfg=None,
                 buckets: Sequence[int] = (8, 32), top_k: int = 10,
                 degraded_top_k: Optional[int] = None, queue_size: int = 64,
                 deadline_s: Optional[float] = None,
                 ckpt_dir: Optional[str] = None, params=None,
                 seed: int = 0, device=None, mesh=None,
                 defer_readiness: bool = False):
        if ckpt_dir is not None and params is not None:
            raise ValueError("pass ckpt_dir or params, not both")
        self.device = resolve_device(device)
        self.arch = get_arch(arch_name)
        if self.arch.family != "seqrec":
            raise ValueError(f"serve.py serves seqrec archs, not {arch_name}")
        self.cfg = self.arch.make_smoke_config() if cfg is None else cfg
        self.router = BucketRouter(buckets)
        self.mesh = mesh
        if mesh is not None:
            if not mesh.member:
                raise ValueError(f"this rank is outside the {mesh.shape} "
                                 f"mesh")
            dp = dp_size(mesh)
            bad = [b for b in self.router.buckets if b % dp]
            if bad:
                raise ValueError(f"buckets {bad} do not divide over the "
                                 f"data axes ({dp}) of the {mesh.shape} "
                                 f"mesh")
        self.top_k = int(top_k)
        self.degraded_top_k = (
            max(1, self.top_k // 2) if degraded_top_k is None
            else int(degraded_top_k)
        )
        if not 0 < self.degraded_top_k <= self.top_k:
            raise ValueError("need 0 < degraded_top_k <= top_k")
        self.queue_size = int(queue_size)
        self.default_deadline_s = deadline_s
        self.degrade_depth = max(1, self.queue_size // 2)

        self.restored_step: Optional[int] = None
        if ckpt_dir is not None:
            params = self._load_params(ckpt_dir)
        elif params is None:
            params = sasrec_lib.init_params(
                self.cfg, seed=seed, device=self.device
            )
        self.params = _to_device(params, self.device)
        self._step = steps_lib.make_seqrec_mips_serve_step(
            self.cfg, top_k=self.top_k, mesh=mesh
        )

        # Device work and the counters it moves run under one lock: the
        # worker thread and bulk score() callers share the card.
        self._run_lock = threading.Lock()
        self._warm: set = set()
        self.compile_count = 0
        self.cache_misses = 0

        self._cond = threading.Condition()
        self._queue: deque[Request] = deque()
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        self.served = 0
        self.degraded_served = 0
        self.rejected = 0

        # The readiness gate: requests are refused with ServerNotReadyError
        # until the serve kernel's canaries pass on this device (no gate
        # under policy "off"); the buckets are warmed once it passes.
        self._gate_passed = False
        self.readiness_error: Optional[str] = None
        if not defer_readiness:
            self.refresh_readiness()

    def _load_params(self, ckpt_dir: str):
        """The params of the newest verified checkpoint under
        ``ckpt_dir``, on the server's device; sets ``restored_step``."""
        mgr = CheckpointManager(ckpt_dir)
        step, params = mgr.restore_params_latest(device=self.device)
        if params is None:
            foreign = mgr.foreign_steps()
            if foreign:
                raise FileNotFoundError(
                    f"no port checkpoint to serve under {ckpt_dir!r}: steps "
                    f"{foreign} hold treedef.pkl, a checkpoint of the JAX "
                    f"package — restore it with repro's CheckpointManager "
                    f"and carry its params across with "
                    f"models/convert.py::sasrec_params_from_jax")
            raise FileNotFoundError(
                f"no checkpoint to serve under {ckpt_dir!r}")
        self.restored_step = step
        return params

    # -- buckets -----------------------------------------------------------
    def _warm_bucket(self, bucket: int) -> None:
        tokens = np.zeros((bucket, self.cfg.max_len), np.int32)
        self._execute(tokens)
        self._warm.add(bucket)
        self.compile_count += 1

    def _execute(self, tokens_padded: np.ndarray):
        tokens = torch.from_numpy(tokens_padded).to(self.device)
        vals, ids = self._step(self.params, tokens)
        return vals.cpu().numpy(), ids.cpu().numpy()

    def _run(self, bucket: int, tokens_padded: np.ndarray):
        """Run the serve step on one padded bucket → host (vals, ids)."""
        with self._run_lock:
            if bucket not in self._warm:  # a shape the router never emits
                self.cache_misses += 1
                self._warm_bucket(bucket)
            return self._execute(tokens_padded)

    # -- readiness / health -------------------------------------------------
    def refresh_readiness(self) -> bool:
        """Run (or fetch) the ``mips_topk`` conformance verdict on the
        server's device and update the readiness flag — the startup gate,
        and the hook an operator calls (after ``guard.clear_verdicts``)
        to re-admit traffic after a fix. Warms the buckets once the gate
        passes. Policy ``off`` skips the verdict."""
        if guard.policy() == "off":
            v = None
        else:
            v = guard.verdict_for("mips_topk", device=self.device)
        if v is not None and not v.passed:
            self._gate_passed = False
            self.readiness_error = (
                f"serve kernel 'mips_topk' failed {v.n_fail}/"
                f"{v.n_fail + v.n_pass} conformance canaries on {v.device}: "
                + "; ".join(v.failures))
            return False
        self._gate_passed = True
        self.readiness_error = None
        with self._run_lock:
            for b in self.router.buckets:
                if b not in self._warm:
                    self._warm_bucket(b)
        return self.ready

    def _require_ready(self) -> None:
        if not self.ready:  # caller holds self._cond
            self.rejected += 1
            raise ServerNotReadyError(
                "server has not passed its conformance readiness gate — "
                + (self.readiness_error
                   or "refresh_readiness() was never run"))

    @property
    def ready(self) -> bool:
        """True once the readiness gate passed and every bucket is warm."""
        return self._gate_passed and \
            len(self._warm) >= len(self.router.buckets)

    def health(self) -> Dict[str, Any]:
        """JSON-ready liveness/readiness snapshot: the readiness flag (and
        why not), the guard policy, queue depth, worker liveness, the
        serve counters and the whole conformance verdict table."""
        with self._cond:
            queue_depth = len(self._queue)
            worker_alive = (
                self._worker is not None and self._worker.is_alive()
            )
            closed = self._closed
        return {
            "ready": self.ready,
            "readiness_error": self.readiness_error,
            "guard_policy": guard.policy(),
            "device": str(self.device),
            "closed": closed,
            "queue_depth": queue_depth,
            "queue_size": self.queue_size,
            "worker_alive": worker_alive,
            "served": self.served,
            "degraded_served": self.degraded_served,
            "rejected": self.rejected,
            "compile_count": self.compile_count,
            "cache_misses": self.cache_misses,
            "conformance": guard.verdict_table(),
        }

    # -- synchronous bulk path --------------------------------------------
    def score(self, histories: np.ndarray):
        """Bulk-serve ``(n, max_len)`` histories synchronously: route
        through the bucket plan, pad, run, unpad. Returns ``(vals, ids)``
        of shape (n, top_k). Raises ``ServerNotReadyError`` while the
        readiness gate has not passed."""
        with self._cond:
            self._require_ready()
        histories = np.asarray(histories, np.int32)
        n = histories.shape[0]
        out_vals, out_ids = [], []
        ofs = 0
        for count, bucket in self.router.plan(n):
            chunk = pad_to_bucket(histories[ofs:ofs + count], bucket)
            vals, ids = self._run(bucket, chunk)
            out_vals.append(unpad(vals, count))
            out_ids.append(unpad(ids, count))
            ofs += count
        with self._cond:
            self.served += n
        if not out_vals:
            return (np.zeros((0, self.top_k), np.float32),
                    np.zeros((0, self.top_k), np.int32))
        return np.concatenate(out_vals), np.concatenate(out_ids)

    # -- async path --------------------------------------------------------
    def submit(self, history: np.ndarray, *,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one ``(max_len,)`` history; returns a :class:`Request`
        handle. Raises ``ServerOverloadedError`` immediately when the
        bounded queue is full or the server is closed, and
        ``ServerNotReadyError`` while the readiness gate has not passed."""
        history = np.asarray(history, np.int32)
        if history.shape != (self.cfg.max_len,):
            raise ValueError(
                f"history shape {history.shape} != ({self.cfg.max_len},)"
            )
        rel = deadline_s if deadline_s is not None else self.default_deadline_s
        deadline = time.monotonic() + rel if rel is not None else None
        req = Request(history, deadline)
        with self._cond:
            if self._closed:
                self.rejected += 1
                raise ServerOverloadedError("server is closed")
            self._require_ready()
            if len(self._queue) >= self.queue_size:
                self.rejected += 1
                raise ServerOverloadedError(
                    f"queue full ({self.queue_size} pending); retry later"
                )
            self._queue.append(req)
            self._ensure_worker()
            self._cond.notify()
        return req

    def _ensure_worker(self) -> None:  # caller holds self._cond
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, name="serve-worker", daemon=True
            )
            self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                batch: List[Request] = []
                while self._queue and len(batch) < self.router.max_bucket:
                    batch.append(self._queue.popleft())
                backlog = len(self._queue)
            try:
                self._serve_batch(
                    batch, overloaded=backlog >= self.degrade_depth
                )
            except Exception as e:  # per-batch isolation: reject, keep serving
                err = ServerOverloadedError(
                    f"serve worker failed mid-batch ({e!r}); request "
                    f"rejected, not served — resubmit to retry"
                )
                err.__cause__ = e
                with self._cond:
                    for r in batch:
                        if not r.done():
                            self.rejected += 1
                            r._fail(err)

    def _serve_batch(self, batch: List[Request], *, overloaded: bool) -> None:
        bucket = self.router.bucket_for(len(batch))
        tokens = pad_to_bucket(np.stack([r.history for r in batch]), bucket)
        vals, ids = self._run(bucket, tokens)
        now = time.monotonic()
        for i, req in enumerate(batch):
            expired = req.deadline is not None and now > req.deadline
            degraded = overloaded or expired
            k = self.degraded_top_k if degraded else self.top_k
            with self._cond:
                self.served += 1
                self.degraded_served += int(degraded)
            req._finish(ServeResult(
                ids=ids[i, :k].copy(), vals=vals[i, :k].copy(),
                degraded=degraded, k=k,
            ))

    def close(self, timeout: float = 10.0) -> None:
        """Stop serving: pending (not-yet-batched) requests are rejected
        with the backpressure error — never silently dropped; the
        in-flight micro-batch (if any) still completes."""
        with self._cond:
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
            self.rejected += len(pending)
        for req in pending:
            req._fail(ServerOverloadedError(
                "server closed before the request was served"
            ))
        if self._worker is not None:
            self._worker.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _to_device(params, device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    return params.to(device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="sasrec-sce")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--buckets", default="8,32",
                    help="comma-separated static batch buckets")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--queue-size", type=int, default=64)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain kernel versions")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the trainer's newest verified "
                         "checkpoint there; omit for random-init smoke params")
    args = ap.parse_args()

    buckets = tuple(int(b) for b in args.buckets.split(","))
    server = RetrievalServer(
        args.arch, buckets=buckets, top_k=args.top_k,
        queue_size=args.queue_size,
        deadline_s=(args.deadline_ms / 1e3
                    if args.deadline_ms is not None else None),
        ckpt_dir=args.ckpt_dir, device=args.device,
    )
    data = SequenceDataset(SeqDataConfig(
        n_items=server.cfg.n_items,
        seq_len=server.cfg.max_len,
        batch_size=args.requests,
    ))
    batch, _ = data.next_batch(Cursor(seed=1))

    t0 = time.monotonic()
    reqs = [server.submit(h) for h in batch["tokens"]]
    results = [r.result(timeout=600.0) for r in reqs]
    dt = time.monotonic() - t0
    lats = sorted(r.latency_ms for r in reqs)
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    src = (f"checkpoint step {server.restored_step}"
           if server.restored_step is not None else "random init (smoke)")
    print(f"served {args.requests} requests on {server.device} in "
          f"{dt*1e3:.1f} ms ({args.requests/dt:.0f} req/s; p50 {p50:.1f} ms, "
          f"p99 {p99:.1f} ms; buckets={server.router.buckets}, "
          f"cache_misses={server.cache_misses}; params: {src})")
    print(f"degraded: {server.degraded_served}, "
          f"rejected: {server.rejected}")
    print("first request top items:", results[0].ids[:5],
          "scores:", results[0].vals[:5])
    server.close()


if __name__ == "__main__":
    main()
