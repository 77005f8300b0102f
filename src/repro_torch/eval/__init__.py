"""Streaming full-catalog evaluation of the port (the leave-one-out slice
of ``repro.eval``): unsampled HR@K / NDCG@K / COV@K and target ranks
without the ``(B, C)`` score matrix.

  ``streaming`` — the scorer front end (one ``eval_fused`` sweep), the
      serving top-k, the metric accumulator and the memory models.
  ``harness``   — the leave-one-out entry point ``evaluate_streaming`` over a
      ``score_fn`` (SASRec), single-device.

``core.metrics`` (dense ``(B, C)`` scores) is the oracle the tests and
``chip_smoke.py`` hold this package against.
"""
from repro_torch.eval.harness import (
    default_score_fn,
    evaluate_streaming,
    sasrec_score_fn,
)
from repro_torch.eval.streaming import (
    MetricAccumulator,
    dense_eval_elements,
    eval_peak_elements,
    ranks_from_counts,
    streaming_eval_scores,
    streaming_rank_topk,
    streaming_topk,
)

__all__ = [
    "MetricAccumulator",
    "default_score_fn",
    "dense_eval_elements",
    "eval_peak_elements",
    "evaluate_streaming",
    "ranks_from_counts",
    "sasrec_score_fn",
    "streaming_eval_scores",
    "streaming_rank_topk",
    "streaming_topk",
]
