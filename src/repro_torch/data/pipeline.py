"""Checkpointable data cursor (port of ``repro/data/pipeline.py``, own
copy; numpy only).

Every dataset is a pure function ``batch = f(seed, step)``, so the
:class:`Cursor` ``(seed, step)`` is the whole pipeline state.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Cursor:
    seed: int
    step: int = 0

    def advance(self, n: int = 1) -> "Cursor":
        return Cursor(seed=self.seed, step=self.step + n)

    def rng(self, *, salt: int = 0) -> np.random.Generator:
        """Deterministic per-(seed, step, salt) generator."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step, salt])
        )
