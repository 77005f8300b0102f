"""Synthetic CTR clickstream for the recsys archs (DCN-v2 / DLRM / xDeepFM)
(port of ``repro/data/clickstream.py``, own copy; numpy only).

Labels come from a hidden bilinear teacher over the sparse-feature
embeddings plus a linear term on the dense features, so the CTR models
have real signal to fit (their interaction ops exist to capture exactly
such bilinear structure). Sparse ids are Zipf-distributed per field —
matching the skew that makes embedding-table sharding interesting.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.data.pipeline import Cursor, ShardedCursor


@dataclasses.dataclass(frozen=True)
class ClickDataConfig:
    vocab_sizes: Tuple[int, ...]
    n_dense: int = 13
    batch_size: int = 256
    hot: int = 1  # ids per field (EmbeddingBag bag size)
    zipf_a: float = 1.1
    teacher_dim: int = 8
    teacher_seed: int = 7


class ClickstreamDataset:
    """``next_batch(cursor) -> ({dense, sparse_ids, labels}, cursor')``."""

    def __init__(self, cfg: ClickDataConfig):
        self.cfg = cfg
        t_rng = np.random.default_rng(cfg.teacher_seed)
        # Hidden teacher: per-field factor vectors + dense weights.
        self._field_vecs = [
            t_rng.normal(size=(v, cfg.teacher_dim)).astype(np.float32)
            / np.sqrt(cfg.teacher_dim)
            for v in cfg.vocab_sizes
        ]
        self._dense_w = t_rng.normal(size=cfg.n_dense).astype(np.float32)

    def _zipf_ids(self, rng, vocab: int, shape) -> np.ndarray:
        # Inverse-CDF Zipf over a finite vocab (fast, vectorized).
        u = rng.random(shape)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        w = ranks ** (-self.cfg.zipf_a)
        cdf = np.cumsum(w) / w.sum()
        return np.searchsorted(cdf, u).astype(np.int32)

    def next_batch(self, cursor: Cursor) -> Tuple[Dict[str, np.ndarray], Cursor]:
        cfg = self.cfg
        rng = cursor.rng(salt=2)
        b = cfg.batch_size
        dense = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
        sparse = np.stack(
            [
                self._zipf_ids(rng, v, (b, cfg.hot))
                for v in cfg.vocab_sizes
            ],
            axis=1,
        )  # (B, F, hot)

        # Teacher logit: sum of pairwise dots of field factors + dense term.
        feats = np.stack(
            [
                self._field_vecs[f][sparse[:, f, 0]]
                for f in range(len(cfg.vocab_sizes))
            ],
            axis=1,
        )  # (B, F, T)
        total = feats.sum(axis=1)
        pair_sum = 0.5 * (
            np.square(np.linalg.norm(total, axis=-1))
            - np.square(np.linalg.norm(feats, axis=-1)).sum(axis=1)
        )
        logit = pair_sum + dense @ self._dense_w
        p = 1.0 / (1.0 + np.exp(-logit / np.sqrt(len(cfg.vocab_sizes))))
        labels = (rng.random(b) < p).astype(np.float32)

        batch = {"dense": dense, "sparse_ids": sparse, "labels": labels}
        return batch, cursor.advance()

    def next_batch_sharded(
        self, scursor: ShardedCursor
    ) -> Tuple[Dict[str, np.ndarray], ShardedCursor]:
        """Host-local rows of the GLOBAL clickstream batch at
        ``scursor`` — same generate-global-slice-local contract as
        ``SequenceDataset.next_batch_sharded`` (the teacher-labelled
        draws are batch-shaped), so resharding never changes the global
        stream."""
        batch, _ = self.next_batch(scursor.cursor)
        return scursor.shard(batch), scursor.advance()
