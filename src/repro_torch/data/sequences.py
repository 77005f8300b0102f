"""Synthetic sequential-recommendation data (port of
``repro/data/sequences.py``, own copy; numpy only).

Items live in ``n_clusters`` latent clusters; a user follows a sticky
Markov chain over clusters and draws items Zipf-distributed within the
current cluster. Batches are a pure function of the :class:`Cursor`, and
equal the reference's batch for batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.data.pipeline import Cursor, ShardedCursor


@dataclasses.dataclass(frozen=True)
class SeqDataConfig:
    n_items: int  # catalog size C (0 is reserved for padding)
    seq_len: int
    batch_size: int
    n_clusters: int = 64
    zipf_a: float = 1.2  # within-cluster popularity skew
    stickiness: float = 0.8  # P(stay in current cluster)
    min_len_frac: float = 0.5  # sequences have random length ≥ frac·L
    pad_id: int = 0


class SequenceDataset:
    """``next_batch(cursor) -> (batch, cursor')`` with
    batch = {tokens (B, L) int32, targets (B, L) int32, valid (B, L) bool}.

    ``targets[i, t] = tokens[i, t+1]`` (next-item prediction); the last
    position and padding are invalid.
    """

    def __init__(self, cfg: SeqDataConfig):
        self.cfg = cfg
        # Item i belongs to cluster i % n_clusters; its popularity rank
        # within the cluster is i // n_clusters.
        usable = cfg.n_items - 1  # id 0 = padding
        self._items_per_cluster = max(1, usable // cfg.n_clusters)

    def _sample_items(self, rng, clusters: np.ndarray) -> np.ndarray:
        """Zipf-ranked item within each given cluster id."""
        cfg = self.cfg
        k = self._items_per_cluster
        ranks = np.arange(1, k + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        p /= p.sum()
        rank = rng.choice(k, size=clusters.shape, p=p)
        items = 1 + clusters + rank * cfg.n_clusters  # interleaved layout
        return np.minimum(items, cfg.n_items - 1).astype(np.int32)

    def next_batch(
        self, cursor: Cursor
    ) -> Tuple[Dict[str, np.ndarray], Cursor]:
        cfg = self.cfg
        rng = cursor.rng(salt=1)
        b, l = cfg.batch_size, cfg.seq_len

        clusters = np.empty((b, l), np.int64)
        clusters[:, 0] = rng.integers(0, cfg.n_clusters, size=b)
        stay = rng.random((b, l)) < cfg.stickiness
        jumps = rng.integers(0, cfg.n_clusters, size=(b, l))
        for t in range(1, l):
            clusters[:, t] = np.where(
                stay[:, t], clusters[:, t - 1], jumps[:, t]
            )
        tokens = self._sample_items(rng, clusters)

        # Random sequence lengths (front-padded like SASRec pipelines).
        min_len = max(2, int(cfg.min_len_frac * l))
        lengths = rng.integers(min_len, l + 1, size=b)
        pos = np.arange(l)[None, :]
        is_real = pos >= (l - lengths[:, None])
        tokens = np.where(is_real, tokens, cfg.pad_id).astype(np.int32)

        targets = np.zeros_like(tokens)
        targets[:, :-1] = tokens[:, 1:]
        valid = is_real.copy()
        valid[:, -1] = False
        valid &= targets != cfg.pad_id
        return {"tokens": tokens, "targets": targets, "valid": valid}, \
            cursor.advance()

    def next_batch_sharded(
        self, scursor: ShardedCursor
    ) -> Tuple[Dict[str, np.ndarray], ShardedCursor]:
        """This host's rows of the GLOBAL batch at ``scursor``: the whole
        global batch is generated (its draws are batch-shaped, so a row
        depends on the whole batch's draw order) and the host's
        contiguous block sliced out, which keeps the global stream bit
        for bit the same under any number of hosts."""
        batch, _ = self.next_batch(scursor.cursor)
        return scursor.shard(batch), scursor.advance()

    def eval_batch(
        self, cursor: Cursor
    ) -> Tuple[Dict[str, np.ndarray], Cursor]:
        """Held-out batch: the same generator on the disjoint ``"eval"``
        split, so its users are unseen (the seqrec leave-one-out eval
        stream). Returns the batch and the split cursor advanced."""
        return self.next_batch(cursor.split("eval"))

    def heldout_batch(
        self, cursor: Cursor
    ) -> Tuple[Dict[str, np.ndarray], Cursor]:
        """Held-out token stream for the LM token-rank protocol: the same
        generator on the disjoint ``"heldout"`` split, every next-token
        position of its sequences an eval row
        (``eval/harness.py::evaluate_streaming_lm``)."""
        return self.next_batch(cursor.split("heldout"))


def lm_batch(cursor: Cursor, vocab: int, batch: int, seq_len: int):
    """A plain LM token batch: the same cluster-Markov generator as a
    pseudo-language, every sequence full length → ``(batch, cursor')``."""
    cfg = SeqDataConfig(n_items=vocab, seq_len=seq_len, batch_size=batch,
                        min_len_frac=1.0)
    return SequenceDataset(cfg).next_batch(cursor)
