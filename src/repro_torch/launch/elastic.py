"""The divergence guard (port of ``DivergenceGuard`` of
``repro/launch/elastic.py``).

A skip / strike / rollback state machine over the per-step loss, which
the trainer (``launch/train.py``) feeds after every step. Its
``loss_cap()`` rides into every batch as a 0-d f32 tensor, so even a
*finite* explosion skips the update on the device
(``launch/steps.py::_apply_update_guarded``).

Left out, with ROADMAP.md queue 1 item 10 (fault tolerance): the
checkpointed rollback. The reference restores the last verified
checkpoint on a ``"rollback"`` verdict; the port has no checkpoints yet,
so its trainer raises the reference's ``RuntimeError`` for a run with no
``--ckpt-dir``, which is what the reference does without one.
``TrainState`` and ``PreemptionHandler`` come with the same item.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from collections import deque

from repro_torch.data.pipeline import Cursor


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
        replayed verbatim — or, with no checkpoint, stop.

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
