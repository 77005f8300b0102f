"""Unsampled top-K ranking metrics over dense scores (port of
``repro/core/metrics.py``): NDCG@K, HR@K, COV@K against the full catalog
(paper §4.1.2).

This module materializes the ``(B, C)`` score matrix on purpose: it is
the dense oracle that the streaming path (``eval/harness.py``, peak
``O(B·(K + block))``) is held against by the tests and by
``chip_smoke.py``. No production path calls it.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def rank_of_target(scores, targets) -> torch.Tensor:
    """0-based rank of each target in its score row; scores (B, C).

    Pessimistic ties: every other score equal to the target's ranks above
    it, ``rank = #{s > t} + max(#{s == t} - 1, 0)`` (the ``- 1`` removes
    the target's own column) — what the streaming counts reproduce."""
    scores = torch.as_tensor(scores)
    targets = torch.as_tensor(targets, device=scores.device).long()
    tgt = torch.gather(scores, 1, targets[:, None])
    gt = (scores > tgt).sum(1)
    eq = (scores == tgt).sum(1)
    return gt + (eq - 1).clamp_min(0)


def topk_metrics(scores, targets, ks: Sequence[int] = (1, 5, 10),
                 catalog: int | None = None) -> Dict[str, float]:
    """HR@K / NDCG@K (equal at K=1) and COV@K over the batch. The top-K
    lists come from a stable descending sort, so equal scores keep the
    lower id first: the streaming path's tie rule."""
    scores = torch.as_tensor(scores)
    ranks = rank_of_target(scores, targets).cpu().numpy()
    c = catalog or scores.shape[1]
    top = torch.sort(scores, dim=1, descending=True, stable=True).indices
    top = top[:, :max(ks)].cpu().numpy()
    out: Dict[str, float] = {}
    for k in ks:
        hit = ranks < k
        out[f"hr@{k}"] = float(hit.mean())
        out[f"ndcg@{k}"] = float(
            np.where(hit, 1.0 / np.log2(ranks + 2.0), 0.0).mean()
        )
        out[f"cov@{k}"] = float(len(np.unique(top[:, :k])) / c)
    return out


def dense_scores(params, cfg, eval_batch) -> Tuple[torch.Tensor, np.ndarray]:
    """Leave-one-out scores of a SASRec model: keep the sequences with at
    least 2 real items, hide the last (right-aligned) item, re-right-align
    the prefix, and score the whole catalog ``Y (n_items, d)`` at the last
    position; the padding id 0 scores ``-inf``. → ``(scores (B', n_items)
    f32 on the params' device, targets (B',) host ids)``."""
    from repro_torch.models import sasrec

    tokens = np.asarray(eval_batch["tokens"])
    tokens = tokens[(tokens != 0).sum(axis=1) >= 2]
    b, l = tokens.shape
    last = l - 1  # sequences are right-aligned (front-padded)
    targets = tokens[np.arange(b), last].copy()
    prefix = tokens.copy()
    prefix[:, last] = 0
    prefix = np.roll(prefix, 1, axis=1)  # keep right alignment
    prefix[:, 0] = 0
    dev = params["item_emb"].device
    with torch.no_grad():
        hidden = sasrec.forward(params, cfg, torch.from_numpy(prefix).to(dev))
        scores = hidden[:, -1] @ sasrec.item_embeddings(params, cfg).T
    scores[:, 0] = -torch.inf  # the padding id is never recommended
    return scores, targets


def evaluate_seqrec(params, cfg, eval_batch, *,
                    ks=(1, 5, 10)) -> Dict[str, float]:
    """Leave-one-out evaluation of a SASRec model over dense scores
    (:func:`dense_scores`, then :func:`topk_metrics`) — the oracle of
    ``eval.harness.evaluate_streaming`` (same protocol, no ``(B, C)``
    matrix there)."""
    scores, targets = dense_scores(params, cfg, eval_batch)
    return topk_metrics(scores, targets, ks=ks, catalog=cfg.n_items)
