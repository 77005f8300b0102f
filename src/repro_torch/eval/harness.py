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

Sharded path: with a ``mesh`` (``dist/sharding.py::make_mesh``) every
rank of it calls the evaluation with the same global batch; the eval
rows go over the data axes (padded to their product by repeating the
last row) and the catalog rows over ``model``. Each model shard sends
``ops.eval_tgt_gather`` over its slice at its ``id_offset``: the owner
adds the target's score and the others exact zeros, ``psum``'d over
``model`` BEFORE the sweep, so every shard compares its columns against
the same target bits. Then one ``ops.eval_fused`` sweep a shard, the rank
counts ``psum``'d, the top-k merged by
``dist.collectives.distributed_topk_from_local`` and the LM's LSE by
``distributed_lse_from_local``; the rows are gathered over the data
axes, so every rank folds the whole batch (:func:`_rank_topk_sharded`).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist.collectives import (
    distributed_lse_from_local,
    distributed_topk_from_local,
    gather_rows,
    psum,
)
from repro_torch.dist.sharding import (
    MODEL_AXIS,
    batch_slice,
    dp_size,
    local_catalog,
    pad_rows,
)
from repro_torch.eval.streaming import (
    MetricAccumulator,
    TokenRankAccumulator,
    ranks_from_counts,
    streaming_eval_scores,
)
from repro_torch.kernels import ops

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
    mesh : optional ``(data, model)`` mesh: the sharded path (module
        docstring); every rank of the mesh calls with the same batch and
        gets the whole batch's metrics.
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
        if mesh is None:
            vals, ids, gt, eq, _tgt, _m, _s = streaming_eval_scores(
                states, catalog, targets, max(ks),
                block_c=block_c, c_lo=1, c_hi=cfg.n_items,
            )
        else:
            vals, ids, gt, eq, _tgt = _rank_topk_sharded(
                states, catalog, targets, max(ks), mesh=mesh,
                block_c=block_c, c_lo=1, c_hi=cfg.n_items,
            )
        mark("sweep")
    acc = accumulator or MetricAccumulator(ks, cfg.n_items)
    acc.update(ranks_from_counts(gt, eq), ids)
    mark("fold")
    return acc.result()


def _rank_topk_sharded(states, catalog, targets, k, *, mesh, block_c, c_lo,
                       c_hi, with_lse=False, logit_softcap=None):
    """The sharded sweep over precomputed eval rows (the module
    docstring's path; the reference's ``_rank_topk_sharded``): every rank
    of ``mesh`` passes the same ``(B, d)`` states, ``(C, d)`` catalog and
    ``(B,)`` targets → ``(vals, ids, gt, eq, tgt)``, plus the merged
    ``lse`` with ``with_lse``, each over all ``B`` rows on every rank."""
    if not mesh.member:
        raise ValueError(f"this rank is outside the {mesh.shape} mesh")
    model, data, dp = mesh.axis(MODEL_AXIS), mesh.axis("data"), dp_size(mesh)
    b = states.shape[0]
    states, targets = pad_rows(states, dp), pad_rows(targets, dp)
    rows = batch_slice(mesh, states.shape[0])
    x_l, t_l = states[rows].contiguous(), targets[rows].contiguous()
    y_l, offset = local_catalog(catalog, mesh)
    # The target's score from the shard that owns its row (the others add
    # exact zeros), summed BEFORE the sweep: every shard ranks its columns
    # against the same bits.
    tgt = psum(ops.eval_tgt_gather(x_l, y_l, t_l, block_c=block_c,
                                   id_offset=offset), model)
    vals_l, ids_l, gt_l, eq_l, _t, m_l, s_l = ops.eval_fused(
        x_l, y_l, t_l, k, tgt_scores=tgt, block_c=block_c, c_lo=c_lo,
        c_hi=c_hi, id_offset=offset, logit_softcap=logit_softcap,
        with_lse=with_lse,
    )
    vals, ids = distributed_topk_from_local(vals_l, ids_l, k, model)
    outs = [vals, ids, psum(gt_l, model), psum(eq_l, model), tgt]
    if with_lse:
        outs.append(distributed_lse_from_local(m_l, s_l, model))
    return tuple(gather_rows(o, data)[:b] for o in outs)


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
    ks : metric cutoffs. mesh : optional — the vocabulary rows over
        ``model`` and the ``B·T`` rows over the data axes, as
        :func:`evaluate_streaming`'s; the per-shard LSE carries merge by
        ``distributed_lse_from_local``. block_c : the plain version's
        chunk. accumulator : fold into an existing one.
    mark : optional hook, called with ``"start"``, ``"h2d"``,
        ``"forward"``, ``"sweep"`` and ``"fold"`` as each phase ends.

    Returns
    -------
    dict — ``hr@k`` / ``ndcg@k`` / ``mean_rank`` / ``loss`` /
    ``n_tokens`` (``TokenRankAccumulator.result``).
    """
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
        if mesh is None:
            _, _, gt, eq, tgt, m, s = streaming_eval_scores(
                states, catalog, t_flat, 1, block_c=block_c, c_lo=1,
                c_hi=cfg.vocab, with_lse=True, logit_softcap=cap,
            )
            lse = m + torch.log(s)
        else:
            _, _, gt, eq, tgt, lse = _rank_topk_sharded(
                states, catalog, t_flat, 1, mesh=mesh, block_c=block_c,
                c_lo=1, c_hi=cfg.vocab, with_lse=True, logit_softcap=cap,
            )
        nll = (lse - apply_softcap(tgt, cap)).cpu().numpy()
        mark("sweep")
    ranks = ranks_from_counts(gt, eq)[v_flat]
    acc = accumulator or TokenRankAccumulator(ks, cfg.vocab)
    acc.update(ranks, nll_sum=float(nll[v_flat].sum()))
    mark("fold")
    return acc.result()
