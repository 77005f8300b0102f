"""Checkpointable data cursor (port of ``repro/data/pipeline.py``, own
copy; numpy only).

Every dataset is a pure function ``batch = f(seed, step)``, so the
:class:`Cursor` ``(seed, step)`` is the whole pipeline state.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Named dataset splits, as seed offsets: a split is the same pure
# generator driven by a disjoint seed, so train and held-out streams never
# share a batch while both stay checkpointable through one Cursor.
SPLIT_SALTS = {
    "train": 0,
    "eval": 0x5EED,  # the seqrec held-out user stream (eval_batch)
    "heldout": 0x70C3,  # the LM held-out token stream (token-rank eval)
}


@dataclasses.dataclass
class Cursor:
    seed: int
    step: int = 0

    def advance(self, n: int = 1) -> "Cursor":
        return Cursor(seed=self.seed, step=self.step + n)

    def split(self, name: str) -> "Cursor":
        """Cursor for the named held-out split (same step, disjoint
        seed). Derive splits from the training cursor: splitting a split
        adds its salt again."""
        return Cursor(seed=self.seed + SPLIT_SALTS[name], step=self.step)

    def rng(self, *, salt: int = 0) -> np.random.Generator:
        """Deterministic per-(seed, step, salt) generator."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step, salt])
        )
