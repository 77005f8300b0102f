"""Elastic-training substrate (port of ``repro/launch/elastic.py``):
preemption handling, the checkpointable train state, and the divergence
guard's state machine.

Everything here exists so the trainer's loop (``launch/train.py``) can
be killed — by the scheduler (SIGTERM), by the kernel (``kill -9``) or
by its own numerics (NaN or exploding loss) — and continue as if nothing
happened:

  * :class:`TrainState` — the one bundle of mutable training state
    (params, optimizer state, the step generator, data cursor, step),
    with the reference's checkpoint dict keys.
  * :class:`PreemptionHandler` — turns SIGTERM / SIGINT into a polled
    flag; the loop finishes the in-flight step, takes a final blocking
    save and exits with :data:`EXIT_PREEMPTED`.
  * :class:`DivergenceGuard` — skip / strike / rollback over the per-step
    loss. Its ``loss_cap()`` rides into every batch as a 0-d f32 tensor,
    so even a finite explosion skips the update on the device
    (``launch/steps.py::_apply_update_guarded``); after ``max_strikes``
    bad steps in a row the trainer restores the last verified checkpoint
    with a reseeded data offset, or raises with no checkpoint to go to.
"""
from __future__ import annotations

import dataclasses
import math
import signal
import statistics
import threading
from collections import deque
from typing import Any, Dict

import torch

from repro_torch.data.pipeline import Cursor, ShardedCursor
from repro_torch.optim.optimizers import tree_leaves

# Exit code for "clean preemption: state saved, relaunch to continue",
# distinct from 0 (done), 1 (crash) and 128 + signum (killed without
# cleanup). Process supervisors key their restart policy on it.
EXIT_PREEMPTED = 42


# ---------------------------------------------------------------------------
# Checkpointable train state
# ---------------------------------------------------------------------------
def _unflatten_like(template, leaves):
    """``template``'s structure (dicts, lists, NamedTuples) over
    ``leaves`` in ``tree_leaves`` order, each as a tensor like the
    template's leaf."""
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], leaves)
                for k in sorted(template)}
    if isinstance(template, list):
        return [_unflatten_like(v, leaves) for v in template]
    if isinstance(template, tuple):
        items = [_unflatten_like(v, leaves) for v in template]
        return (type(template)(*items) if hasattr(template, "_fields")
                else tuple(items))
    return torch.as_tensor(next(leaves)).to(device=template.device,
                                            dtype=template.dtype)


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):  # the CTR models' per-field tables
        return [_to_tensors(v, device) for v in tree]
    return torch.as_tensor(tree).to(device)


@dataclasses.dataclass
class TrainState:
    """Everything the train loop mutates, as one checkpointable unit.

    ``step`` is the index of the last completed step (−1 before any).
    The checkpoint dict keys (``params`` / ``opt_state`` / ``key`` /
    ``cursor`` / ``step``) are the reference's. ``key`` holds the state
    of the trainer's ``torch.Generator`` (``get_state()``, a uint8
    array) where the reference keeps its PRNG key: restored into a
    generator on the trainer's device, it makes the draws after a resume
    those of an uninterrupted run.
    """

    params: Any
    opt_state: Any
    generator: torch.Generator
    cursor: Cursor
    step: int = -1

    def to_ckpt(self, *, n_hosts: int = 1) -> Dict[str, Any]:
        return {
            "params": self.params,
            "opt_state": self.opt_state,
            "key": self.generator.get_state(),
            # Through ShardedCursor, so the topology at save time (host 0
            # of ``n_hosts``) is recorded; restore ignores it (the
            # resharding contract).
            "cursor": ShardedCursor(self.cursor, host_id=0,
                                    n_hosts=n_hosts).to_state(),
            "step": self.step,
        }

    @classmethod
    def from_ckpt(cls, tree: Dict[str, Any], *, opt_template: Any,
                  device=None) -> "TrainState":
        """Rebuild from a restored checkpoint dict. ``opt_template`` is an
        optimizer state of the same model (the trainer passes its
        current one; only its structure, the ``OptState`` NamedTuple,
        and its leaves' devices and dtypes are read) that the restored
        leaves take; the params and the generator go to ``device``
        (default: the template's)."""
        if device is None:
            device = tree_leaves(opt_template)[0].device
        opt_state = _unflatten_like(opt_template,
                                    iter(tree_leaves(tree["opt_state"])))
        generator = torch.Generator(device=device)
        generator.set_state(torch.as_tensor(tree["key"]).to("cpu",
                                                            torch.uint8))
        return cls(params=_to_tensors(tree["params"], device),
                   opt_state=opt_state, generator=generator,
                   cursor=Cursor.from_state(tree["cursor"]),
                   step=int(tree["step"]))


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------
class PreemptionHandler:
    """SIGTERM / SIGINT → a flag the step loop polls.

    Installed only on the main thread (elsewhere signal handlers cannot
    be installed, and a loop driven from another thread just never sees
    ``preempted``); the previous handlers are restored on exit, so
    nesting and test runs stay safe. A second signal during the drain
    restores the previous handler and raises the signal again, so a
    stuck final save can still be interrupted.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._event = threading.Event()
        self._prev: Dict[int, Any] = {}

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def _handle(self, signum, frame):
        if self._event.is_set():  # a second signal: stop being graceful
            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            signal.raise_signal(signum)
            return
        print(f"[preempt] caught signal {signum}: finishing step, saving, "
              f"exiting {EXIT_PREEMPTED}", flush=True)
        self._event.set()

    def __enter__(self) -> "PreemptionHandler":
        if threading.current_thread() is threading.main_thread():
            for s in self.SIGNALS:
                self._prev[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False


# ---------------------------------------------------------------------------
# Divergence guard
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DivergenceGuard:
    """Skip / strike / rollback state machine over the per-step loss.

    States (per observed step):
      * **ok** — finite loss under the cap: strikes reset, the loss joins
        the running-median window.
      * **strike** — the step was skipped on the device (non-finite loss
        or gradients, or loss above ``loss_cap()``): params and optimizer
        state were NOT updated, strike count += 1.
      * **rollback** — ``max_strikes`` consecutive strikes: the driver
        must restore the last verified checkpoint and reseed the data
        offset (``reseed``) so the stream that poisoned the run is not
        replayed verbatim — or, with no checkpoint to go to, stop.

    ``loss_cap()`` is ``inf`` during the first ``warmup`` healthy steps
    (no baseline yet), then ``cap_factor ×`` the median of the last
    ``window`` healthy losses.
    """

    max_strikes: int = 3
    cap_factor: float = 100.0
    warmup: int = 8
    window: int = 32
    # Data-offset stride applied per rollback: the restored cursor is
    # advanced by rollbacks × this (prime, so repeated rollbacks never
    # re-align with typical eval/checkpoint periods).
    reseed_stride: int = 13

    strikes: int = 0
    rollbacks: int = 0

    def __post_init__(self):
        self._recent: deque = deque(maxlen=self.window)

    def loss_cap(self) -> float:
        if len(self._recent) < self.warmup:
            return math.inf
        return self.cap_factor * statistics.median(self._recent)

    def observe(self, loss: float, *, skipped: bool) -> str:
        """Feed one step's outcome; returns "ok" | "strike" | "rollback"."""
        bad = skipped or not math.isfinite(loss) or loss > self.loss_cap()
        if not bad:
            self.strikes = 0
            self._recent.append(loss)
            return "ok"
        self.strikes += 1
        if self.strikes >= self.max_strikes:
            self.strikes = 0
            self.rollbacks += 1
            self._recent.clear()  # the post-rollback regime starts fresh
            return "rollback"
        return "strike"

    def reseed(self, cursor: Cursor) -> Cursor:
        """Restored data cursor with the post-rollback offset applied."""
        return cursor.advance(self.reseed_stride * self.rollbacks)
