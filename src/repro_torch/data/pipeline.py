"""Checkpointable data cursor and per-host sharding (port of
``repro/data/pipeline.py``, own copy; numpy only).

Every dataset is a pure function ``batch = f(seed, step)``, so the
:class:`Cursor` ``(seed, step)`` is the whole pipeline state: stored in a
checkpoint, it continues the stream exactly where it stopped.
:class:`ShardedCursor` adds a ``(host_id, n_hosts)`` view: host ``h`` of
``H`` owns the ``h``-th contiguous block of the global batch's rows, and
the checkpoint keeps only the global ``(seed, step)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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

    def to_state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_state(state: dict) -> "Cursor":
        return Cursor(seed=int(state["seed"]), step=int(state["step"]))


def shard_batch(batch: Dict[str, np.ndarray], host_id: int,
                n_hosts: int) -> Dict[str, np.ndarray]:
    """Host ``host_id``'s contiguous row-block of a global batch dict.

    Every array is sliced on axis 0 (the batch axis), so
    ``concat_h(shard_batch(b, h, H)) == b`` for any ``H`` dividing the
    row count. A row count that ``n_hosts`` does not divide raises:
    resharding must never change the global stream."""
    if not 0 <= host_id < n_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {n_hosts})")
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % n_hosts:
            raise ValueError(
                f"batch leaf {k!r} has {rows} rows, not divisible by "
                f"n_hosts={n_hosts}"
            )
        per = rows // n_hosts
        out[k] = v[host_id * per:(host_id + 1) * per]
    return out


@dataclasses.dataclass
class ShardedCursor:
    """Host-local view of the global :class:`Cursor` stream.

    The state is the underlying ``(seed, step)`` only: ``to_state``
    records ``host_id`` / ``n_hosts`` as information, and ``from_state``
    takes the current topology as arguments and ignores the recorded
    one. Restoring a checkpoint written on H hosts onto H′ therefore
    re-partitions the same global stream.
    """

    cursor: Cursor
    host_id: int = 0
    n_hosts: int = 1

    def __post_init__(self):
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        if not 0 <= self.host_id < self.n_hosts:
            raise ValueError(
                f"host_id {self.host_id} not in [0, {self.n_hosts})"
            )

    def advance(self, n: int = 1) -> "ShardedCursor":
        return dataclasses.replace(self, cursor=self.cursor.advance(n))

    def split(self, name: str) -> "ShardedCursor":
        return dataclasses.replace(self, cursor=self.cursor.split(name))

    def resharded(self, host_id: int, n_hosts: int) -> "ShardedCursor":
        """The same global stream position under a new host topology."""
        return ShardedCursor(self.cursor, host_id=host_id, n_hosts=n_hosts)

    def shard(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This host's rows of a batch generated from ``self.cursor``."""
        return shard_batch(batch, self.host_id, self.n_hosts)

    def to_state(self) -> dict:
        return {
            "seed": self.cursor.seed,
            "step": self.cursor.step,
            "host_id": self.host_id,
            "n_hosts": self.n_hosts,
        }

    @staticmethod
    def from_state(state: dict, *, host_id: int = 0,
                   n_hosts: int = 1) -> "ShardedCursor":
        """Restore onto the current topology, which may differ from the
        one recorded at save time."""
        return ShardedCursor(Cursor.from_state(state), host_id=host_id,
                             n_hosts=n_hosts)
