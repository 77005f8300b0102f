"""Streaming full-catalog evaluation of the port (the single-device
slice of ``repro.eval``): unsampled HR@K / NDCG@K / COV@K and target
ranks without the ``(B, C)`` score matrix, and the LM's token-rank
protocol.

  ``streaming`` — the scorer front end (one ``eval_fused`` sweep), the
      serving top-k, the metric accumulator and the memory models.
  ``harness``   — the leave-one-out entry point ``evaluate_streaming`` over a
      ``score_fn`` (SASRec, BERT4Rec's Cloze), and
      ``evaluate_streaming_lm`` (every next-token position of a
      transformer LM), single-device.

``core.metrics`` (dense ``(B, C)`` scores) is the oracle the tests and
``chip_smoke.py`` hold this package against.
"""
from repro_torch.eval.harness import (
    bert4rec_score_fn,
    default_score_fn,
    evaluate_streaming,
    evaluate_streaming_lm,
    lm_score_fn,
    lm_targets_and_valid,
    sasrec_score_fn,
)
from repro_torch.eval.streaming import (
    MetricAccumulator,
    TokenRankAccumulator,
    dense_eval_elements,
    eval_peak_elements,
    ranks_from_counts,
    streaming_eval_scores,
    streaming_rank_topk,
    streaming_topk,
)

__all__ = [
    "MetricAccumulator",
    "TokenRankAccumulator",
    "bert4rec_score_fn",
    "default_score_fn",
    "dense_eval_elements",
    "eval_peak_elements",
    "evaluate_streaming",
    "evaluate_streaming_lm",
    "lm_score_fn",
    "lm_targets_and_valid",
    "ranks_from_counts",
    "sasrec_score_fn",
    "streaming_eval_scores",
    "streaming_rank_topk",
    "streaming_topk",
]
