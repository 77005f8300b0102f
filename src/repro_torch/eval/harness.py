"""Leave-one-out streaming evaluation (port of the single-device part
of ``repro/eval/harness.py``).

The same protocol and metrics as the dense oracle
``core/metrics.py::evaluate_seqrec``, scored through
``eval/streaming.py`` so that no ``(B, C)`` score matrix exists.
Models plug in through a ``score_fn``::

    score_fn(params, tokens) -> (states, catalog)

where ``tokens`` (a tensor on the params' device) are the kept
right-aligned eval sequences with the held-out target still in the last
column, ``states`` the ``(B, d)`` contiguous user states at the scoring
position and ``catalog`` the shard-even ``(C_pad, d)`` item table
(``loss_catalog``; the phantom rows are masked by id window).
``sasrec_score_fn`` hides the target and re-right-aligns;
``bert4rec_score_fn`` replaces it with [MASK] (the Cloze protocol).

The LM's held-out token-rank protocol (:func:`evaluate_streaming_lm`)
scores every next-token position against the vocabulary through the
same sweep (``lm_score_fn``), with the online LSE for the next-token
loss.

Left out, with its ROADMAP.md queue: the sharded path (``mesh=``,
queue 1 item 14).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.eval.streaming import (
    MetricAccumulator,
    TokenRankAccumulator,
    ranks_from_counts,
    streaming_eval_scores,
)

ScoreFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def sasrec_score_fn(cfg) -> ScoreFn:
    """Causal leave-one-out: hide the last real item, re-right-align,
    encode, take the last position's hidden state."""
    from repro_torch.models import sasrec

    def fn(params, tokens):
        last = tokens.shape[1] - 1
        prefix = tokens.clone()
        prefix[:, last] = 0
        prefix = torch.roll(prefix, 1, dims=1)  # keep right alignment
        prefix[:, 0] = 0
        hidden = sasrec.forward(params, cfg, prefix)
        return hidden[:, -1].contiguous(), sasrec.loss_catalog(params, cfg)

    return fn


def bert4rec_score_fn(cfg) -> ScoreFn:
    """Cloze leave-one-out: replace the held-out item with [MASK] and
    score that position (the Sun et al. 2019 eval protocol)."""
    from repro_torch.models import bert4rec as b4r
    from repro_torch.models import sasrec

    def fn(params, tokens):
        masked = tokens.clone()
        masked[:, -1] = b4r.mask_token_id(cfg)
        hidden = b4r.forward(params, cfg, masked)
        return hidden[:, -1].contiguous(), sasrec.loss_catalog(params, cfg)

    return fn


def default_score_fn(cfg) -> ScoreFn:
    """SASRec for causal configs, BERT4Rec otherwise."""
    return sasrec_score_fn(cfg) if cfg.causal else bert4rec_score_fn(cfg)


def _keep_and_targets(tokens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the sequences with ≥ 2 real items; the held-out target is the
    last (right-aligned) position."""
    lengths = (tokens != 0).sum(axis=1)
    kept = tokens[lengths >= 2]
    b, l = kept.shape
    targets = kept[np.arange(b), l - 1].copy()
    return kept, targets


def evaluate_streaming(
    params,
    cfg,
    eval_batch,
    *,
    ks: Sequence[int] = (1, 5, 10),
    score_fn: Optional[ScoreFn] = None,
    mesh=None,
    block_c: int = 512,
    accumulator: Optional[MetricAccumulator] = None,
    mark=None,
) -> Dict[str, float]:
    """Leave-one-out evaluation without materializing ``(B, C)`` scores.

    Parameters
    ----------
    params, cfg : model parameters (on the device the evaluation runs
        on: the card's kernels for CUDA tensors, the plain versions on
        the CPU) and its ``SeqRecConfig``.
    eval_batch : dict with right-aligned ``"tokens"`` (B, L), as
        ``SequenceDataset.eval_batch`` gives it.
    ks : metric cutoffs.
    score_fn : the model protocol (default: :func:`default_score_fn`).
    mesh : not ported (raises).
    block_c : the plain version's chunk.
    accumulator : fold into an existing ``MetricAccumulator`` (several
        batches); a fresh one otherwise.
    mark : optional hook, called with ``"start"`` once the host batch is
        ready, then as each phase ends: ``"h2d"``, ``"forward"``,
        ``"sweep"`` (``eval_tgt_gather`` and ``eval_fused``), ``"fold"``
        (ranks and ids to the host, into the accumulator) — a hook to
        time each phase.

    Returns
    -------
    dict with ``hr@k`` / ``ndcg@k`` / ``cov@k`` — on one batch the
    values of the dense oracle ``core.metrics.topk_metrics`` wherever
    the ranks are unambiguous.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded eval path is not ported: ROADMAP.md queue 1 item 14"
        )
    if score_fn is None:
        score_fn = default_score_fn(cfg)
    mark = mark or (lambda name: None)
    tokens, targets = _keep_and_targets(np.asarray(eval_batch["tokens"]))
    dev = params["item_emb"].device
    mark("start")
    with torch.no_grad():
        tokens = torch.from_numpy(tokens).to(dev)
        targets = torch.from_numpy(targets.astype(np.int32)).to(dev)
        mark("h2d")
        states, catalog = score_fn(params, tokens)
        mark("forward")
        vals, ids, gt, eq, _tgt, _m, _s = streaming_eval_scores(
            states, catalog, targets, max(ks),
            block_c=block_c, c_lo=1, c_hi=cfg.n_items,
        )
        mark("sweep")
    acc = accumulator or MetricAccumulator(ks, cfg.n_items)
    acc.update(ranks_from_counts(gt, eq), ids)
    mark("fold")
    return acc.result()


# ---------------------------------------------------------------------------
# Held-out token-rank protocol (LM family)
# ---------------------------------------------------------------------------
def lm_score_fn(cfg) -> ScoreFn:
    """Next-token protocol of the transformer LM: one forward over the
    ``(B, T)`` tokens, every position an eval row — ``(B·T, d)`` states
    against the full padded output table ``(V_pad, d)``. Which rows count
    is the validity mask's business, after the sweep. The final-logit
    softcap is monotone, so ranks use the raw scores; the loss applies
    it (:func:`evaluate_streaming_lm`)."""
    from repro_torch.models import transformer as tf_lib

    def fn(params, tokens):
        hidden, _ = tf_lib.forward(params, cfg, tokens)
        states = hidden.reshape(-1, hidden.shape[-1]).contiguous()
        return states, tf_lib.output_embedding(params, cfg)

    return fn


def lm_targets_and_valid(tokens: np.ndarray,
                         pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Next-token targets and validity of a ``(B, T)`` token batch:
    ``targets[i, t] = tokens[i, t + 1]``; a position counts iff it is a
    real token and so is the next — the final column and padding never
    (``SequenceDataset.next_batch``'s convention)."""
    tokens = np.asarray(tokens)
    targets = np.zeros_like(tokens)
    targets[:, :-1] = tokens[:, 1:]
    valid = tokens != pad_id
    valid[:, -1] = False
    valid &= targets != pad_id
    return targets, valid


def evaluate_streaming_lm(
    params,
    cfg,
    eval_batch,
    *,
    ks: Sequence[int] = (1, 5, 10),
    mesh=None,
    block_c: int = 512,
    accumulator: Optional[TokenRankAccumulator] = None,
    mark=None,
) -> Dict[str, float]:
    """Held-out token-rank evaluation of a transformer LM: every
    next-token position scored against the vocabulary, without the
    ``(B·T, V)`` logits.

    One ``transformer.forward`` gives ``(B·T, d)`` eval rows
    (:func:`lm_score_fn`); ONE ``eval_fused`` sweep at k = 1 over the
    global ids ``[1, V)`` (no pad id, no phantom rows) gives each row's
    target rank (pessimistic ties) and, with the online LSE of the
    softcapped logits, its next-token NLL ``lse − softcap(tgt)``.
    Padding and final positions are dropped by the validity mask before
    the fold into the :class:`TokenRankAccumulator`.

    Parameters
    ----------
    params, cfg : transformer parameters (their device runs the eval: the
        card's kernels for CUDA tensors) and ``TransformerConfig``.
    eval_batch : dict with ``"tokens"`` (B, T); its ``"targets"`` /
        ``"valid"`` are used when present, else
        :func:`lm_targets_and_valid`.
    ks : metric cutoffs. mesh : not ported (raises). block_c : the plain
        version's chunk. accumulator : fold into an existing one.
    mark : optional hook, called with ``"start"``, ``"h2d"``,
        ``"forward"``, ``"sweep"`` and ``"fold"`` as each phase ends.

    Returns
    -------
    dict — ``hr@k`` / ``ndcg@k`` / ``mean_rank`` / ``loss`` /
    ``n_tokens`` (``TokenRankAccumulator.result``).
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded eval path is not ported: ROADMAP.md queue 1 item 14"
        )
    from repro_torch.core.sce import apply_softcap

    mark = mark or (lambda name: None)
    tokens = np.asarray(eval_batch["tokens"])
    if "targets" in eval_batch and "valid" in eval_batch:
        targets = np.asarray(eval_batch["targets"])
        valid = np.asarray(eval_batch["valid"])
    else:
        targets, valid = lm_targets_and_valid(tokens)
    v_flat = valid.reshape(-1)
    dev = params["embed"].device
    cap = getattr(cfg, "final_softcap", None)
    mark("start")
    with torch.no_grad():
        tok = torch.from_numpy(tokens).to(dev)
        t_flat = torch.from_numpy(
            targets.reshape(-1).astype(np.int32)).to(dev)
        mark("h2d")
        states, catalog = lm_score_fn(cfg)(params, tok)
        mark("forward")
        _, _, gt, eq, tgt, m, s = streaming_eval_scores(
            states, catalog, t_flat, 1, block_c=block_c, c_lo=1,
            c_hi=cfg.vocab, with_lse=True, logit_softcap=cap,
        )
        lse = m + torch.log(s)
        nll = (lse - apply_softcap(tgt, cap)).cpu().numpy()
        mark("sweep")
    ranks = ranks_from_counts(gt, eq)[v_flat]
    acc = accumulator or TokenRankAccumulator(ks, cfg.vocab)
    acc.update(ranks, nll_sum=float(nll[v_flat].sum()))
    mark("fold")
    return acc.result()
