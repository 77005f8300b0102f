"""Streaming catalog scoring and incremental metric accumulators (port
of ``repro/eval/streaming.py``, without the LM's token-rank accumulator).

The unsampled metrics the paper reports (HR@K, NDCG@K, COV@K, §4.1.2)
are functions of two small per-user quantities — the target's rank among
all catalog scores and the top-``K`` recommended ids — not of the scores
themselves. :func:`streaming_eval_scores` computes exactly those in ONE
catalog sweep (``kernels/ops.py::eval_fused``: the hand-written CUDA
kernel on the card, its plain chunked version on the CPU) with no
``(B, C)`` score matrix, and :class:`MetricAccumulator` folds them into
running sums. :func:`streaming_topk` is the serving slice of the same
sweep. Both dispatch through the guarded ``ops`` entries: on the card
the kernel guard's preflight and ``eval_fused`` / ``mips_topk`` verdicts
run first, and a failed verdict raises — there is no degraded path to
the plain version (the reference's ``warn`` policy has one).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.topk_merge import streaming_topk_elements


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def streaming_eval_scores(
    x,
    y,
    targets,
    k: int,
    *,
    block_c: int = 512,
    c_lo: int = 0,
    c_hi: Optional[int] = None,
    id_offset: int = 0,
    with_lse: bool = False,
    logit_softcap: Optional[float] = None,
):
    """Everything an eval protocol needs from ONE catalog sweep: top-k
    ids and values, the target's rank counts, the target score and
    (``with_lse``) the online-LSE pair.

    Parameters
    ----------
    x : (B, d) user states; y : (C, d) catalog table (or a shard whose
        first row has global id ``id_offset``); targets : (B,) int32
        global ids of the held-out items.
    k : top-k size (``max(ks)`` of the metrics wanted).
    block_c : the plain version's chunk (peak live score elements
        ``B·(block_c + 2k)``); the kernel plans its own split.
    c_lo, c_hi : valid global-id window (mask the padding id 0 with
        ``c_lo=1``, phantom padded rows with ``c_hi=n_items``).
    with_lse, logit_softcap : carry the f32 online LSE of the softcapped
        logits (``lse = m + log s``); ranks keep raw scores.

    Returns
    -------
    ``(vals, ids, gt, eq, tgt, m, s)`` — see ``kernels/ops.py::
    eval_fused``. The threshold is bit for bit the swept target column,
    so ``ranks_from_counts(gt, eq)`` ranks against the sweep's own
    scores.
    """
    return ops.eval_fused(
        x, y, targets, k,
        block_c=block_c, c_lo=c_lo, c_hi=c_hi, id_offset=id_offset,
        logit_softcap=logit_softcap, with_lse=with_lse,
    )


def streaming_rank_topk(
    x,
    y,
    targets,
    k: int,
    *,
    block_c: int = 512,
    c_lo: int = 0,
    c_hi: Optional[int] = None,
    id_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k values and ids and the target's rank counts without
    ``(B, C)`` scores: the rank-metrics slice of
    :func:`streaming_eval_scores` → ``(vals, ids, gt, eq)``."""
    vals, ids, gt, eq, _tgt, _m, _s = streaming_eval_scores(
        x, y, targets, k,
        block_c=block_c, c_lo=c_lo, c_hi=c_hi, id_offset=id_offset,
    )
    return vals, ids, gt, eq


def streaming_topk(
    x,
    y,
    k: int,
    *,
    c_lo: int = 0,
    c_hi: Optional[int] = None,
    id_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-``k`` of ``x @ yᵀ`` over the global-id window
    ``[c_lo, c_hi)`` — what the retrieval server calls per request
    micro-batch. Catalog rows outside the window (the padding row 0, the
    phantom rows ``>= n_items``) are never selected; no ``(B, C)`` score
    matrix exists. Returned ids are global (``id_offset`` included).
    """
    c = y.shape[0]
    gids = id_offset + torch.arange(c, device=y.device)
    hi = (id_offset + c) if c_hi is None else c_hi
    valid = (gids >= c_lo) & (gids < hi)
    return ops.mips_topk(x, y, min(k, c), valid=valid, id_offset=id_offset)


def ranks_from_counts(gt, eq) -> np.ndarray:
    """Pessimistic-tie rank from the streamed counts: ``gt`` scores beat
    the target, ``eq`` equal it (its own column included) → rank
    ``gt + max(eq - 1, 0)``, the convention of
    ``core.metrics.rank_of_target``. Returns a host array."""
    gt = _host(gt)
    eq = _host(eq)
    return gt + np.maximum(eq - 1, 0)


def _fold_hit_ndcg(ranks, ks, hit_sums, ndcg_sums) -> None:
    """Fold a batch of 0-based ranks into running per-``k`` HR / NDCG
    sums: a hit is ``rank < k``, its NDCG gain ``1/log2(rank + 2)``."""
    for k in ks:
        hit = ranks < k
        hit_sums[k] += float(hit.sum())
        ndcg_sums[k] += float(
            np.where(hit, 1.0 / np.log2(ranks + 2.0), 0.0).sum()
        )


class MetricAccumulator:
    """Fold per-batch ``(ranks, topk_ids)`` into running HR/NDCG/COV sums.

    The streaming form of ``core.metrics.topk_metrics``: on one batch
    the results are identical; across batches HR/NDCG average over all
    users and COV@K counts the distinct recommended items of the whole
    run (a ``(C,)`` seen-mask per K on the host).

    Parameters
    ----------
    ks : cutoffs, e.g. ``(1, 5, 10)``.
    catalog : COV denominator ``C`` (``cfg.n_items``).
    """

    def __init__(self, ks: Sequence[int], catalog: int):
        self.ks = tuple(ks)
        self.catalog = int(catalog)
        self.n_users = 0
        self._hit = {k: 0.0 for k in self.ks}
        self._ndcg = {k: 0.0 for k in self.ks}
        self._seen = {k: np.zeros(self.catalog, bool) for k in self.ks}

    def update(self, ranks, topk_ids) -> None:
        """Fold one batch.

        Parameters
        ----------
        ranks : (B,) 0-based target ranks (``ranks_from_counts``).
        topk_ids : (B, >= max(ks)) global recommended ids, best first
            (tensor or array); ids outside ``[0, catalog)`` — the
            ``ID_PAD`` tail when ``k`` exceeds the valid columns — are
            ignored for COV.
        """
        ranks = _host(ranks)
        topk_ids = _host(topk_ids)
        self.n_users += len(ranks)
        _fold_hit_ndcg(ranks, self.ks, self._hit, self._ndcg)
        for k in self.ks:
            ids = topk_ids[:, :k].ravel()
            ids = ids[(ids >= 0) & (ids < self.catalog)]
            self._seen[k][ids] = True

    def result(self) -> Dict[str, float]:
        """Metric dict in the key format of ``topk_metrics``."""
        n = max(self.n_users, 1)
        out: Dict[str, float] = {}
        for k in self.ks:
            out[f"hr@{k}"] = self._hit[k] / n
            out[f"ndcg@{k}"] = self._ndcg[k] / n
            out[f"cov@{k}"] = float(self._seen[k].sum()) / self.catalog
        return out


def eval_peak_elements(batch: int, k: int, block_c: int = 512) -> int:
    """Peak live score-side elements of the streaming path's plain
    version: one ``(B, block_c)`` score tile and the ``(B, k)``
    value/id merge buffers (``topk_merge.streaming_topk_elements``) plus
    the ``(B,)`` ``gt``/``eq`` pair — ``O(B·(K + block))``, independent
    of ``C``. The threshold is an input (``eval_tgt_gather``), not an
    accumulator."""
    return streaming_topk_elements(batch, k, block_c) + 2 * batch


def dense_eval_elements(batch: int, catalog: int) -> int:
    """Score-side elements of the materializing path: the full
    ``(B, C)`` matrix."""
    return batch * catalog
