"""Plain PyTorch versions of the kernels (port of the slice of
``repro/kernels/ref.py`` this package has kernels for: the MIPS top-k and
the in-bucket SCE loss).

They are the CPU path of ``kernels/ops.py`` and the yardstick the tests
and ``chip_smoke.py`` hold each CUDA kernel against. No production path
takes them for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_merge import ID_PAD, NEG_INF, merge_topk_tile


def _masked_neg_logits(x_b, y_b, tgt_b, cand_ids, logit_softcap=None):
    """Collision- and validity-masked in-bucket negative logits (f32),
    ``(n_b, b_x, b_y)``. A candidate equal to the position's target is
    not a negative; a candidate with a negative id is an invalid slot
    for every position. The softcap applies before the mask, so masked
    slots stay at ``NEG_INF``, never ``−cap``."""
    neg = torch.einsum("nxd,nyd->nxy", x_b.to(torch.float32),
                       y_b.to(torch.float32))
    if logit_softcap is not None:
        neg = logit_softcap * torch.tanh(neg / logit_softcap)
    collide = cand_ids[:, None, :] == tgt_b[:, :, None]
    invalid = collide | (cand_ids < 0)[:, None, :]
    return torch.where(invalid, NEG_INF, neg)


def sce_bucket_loss_ref(x_b, y_b, tgt_b, cand_ids, pos_logit,
                        logit_softcap=None):
    """In-bucket CE (Algorithm 1, lines 12–15) over pre-gathered
    candidates ``y_b`` (n_b, b_y, d) → (n_b, b_x) losses:
    ``logsumexp([pos, negatives]) − pos`` with the masked slots of
    :func:`_masked_neg_logits` left out. ``pos_logit`` arrives already
    capped. Differentiable by autograd."""
    neg = _masked_neg_logits(x_b, y_b, tgt_b, cand_ids, logit_softcap)
    pos = pos_logit.to(torch.float32)
    m = torch.maximum(neg.amax(dim=-1), pos)
    s = torch.exp(neg - m[..., None]).sum(dim=-1) + torch.exp(pos - m)
    return (m + torch.log(s) - pos).to(pos_logit.dtype)


def sce_gather_loss_ref(x_b, y, idx_y, tgt_b, cand_ids, pos_logit,
                        logit_softcap=None):
    """The plain version of ``kernels/sce_prefetch.py``: gather the
    candidate rows ``y[idx_y]`` (ids clamped to ``[0, C)``, as the
    reference's ops layer does), then :func:`sce_bucket_loss_ref`. Its
    autograd gradient of ``y`` is the scatter-add the dY kernel does
    without the ``(n_b, b_y, d)`` tensor."""
    y_b = y[idx_y.long().clamp(0, y.shape[0] - 1)]
    return sce_bucket_loss_ref(x_b, y_b, tgt_b, cand_ids, pos_logit,
                               logit_softcap)


def mips_topk_ref(q, y, k: int, *, valid=None, chunk: int = 512,
                  id_offset: int = 0):
    """Chunked streaming per-row top-``k`` of ``q @ yᵀ`` — the plain
    version of ``kernels/mips_topk.py``.

    Walks ``(chunk, d)`` catalog slices in f32, carrying only the
    ``(n_q, k)`` value/id buffers through :func:`merge_topk_tile`.
    ``k`` is clamped to ``C``; rows with ``valid == 0`` and nothing past
    ``C`` are ever selected; ids are ``id_offset + row`` (int32), ties go
    to the lower id and starved slots hold ``(NEG_INF, ID_PAD)``.
    → ``(vals (n_q, k) f32, ids (n_q, k) int32)``.
    """
    n_q = q.shape[0]
    c = y.shape[0]
    k = min(k, c)
    chunk = max(1, min(chunk, c))
    q32 = q.to(torch.float32)
    vals = torch.full((n_q, k), NEG_INF, dtype=torch.float32, device=q.device)
    ids = torch.full((n_q, k), ID_PAD, dtype=torch.int32, device=q.device)
    for lo in range(0, c, chunk):
        hi = min(lo + chunk, c)
        s = q32 @ y[lo:hi].to(torch.float32).T  # (n_q, hi - lo)
        if valid is not None:
            ok = valid[lo:hi].to(torch.bool)
            s = torch.where(ok[None, :], s, torch.full_like(s, NEG_INF))
        col = torch.arange(
            id_offset + lo, id_offset + hi, dtype=torch.int32, device=q.device
        ).expand(n_q, -1)
        vals, ids = merge_topk_tile(vals, ids, s, col, k)
    return vals, ids
