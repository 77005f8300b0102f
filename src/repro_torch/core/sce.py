"""Scalable Cross-Entropy (SCE) loss — Algorithm 1 of Mezentsev et al.,
RecSys '24, with the Mix bucket centres (paper §3.2). Port of
``repro/core/sce.py``.

Over a catalog of ``C`` items the loss approximates full cross-entropy by

  1. drawing ``n_b`` bucket centres ``B`` (``randn``, or with Mix a random
     projection of the model outputs, ``B = Ω X``);
  2. selecting per bucket the top-``b_x`` model outputs and top-``b_y``
     catalog rows by inner product with its centre;
  3. computing the in-bucket logits ``X[I_b] Y[J_b]ᵀ`` with the positive
     class masked out of the negatives, and a per-position CE against the
     positive logit;
  4. keeping per position the largest loss over the buckets that hold it,
     and averaging over the positions covered by at least one bucket.

Two paths, as in the reference: the plain one materialises the
``(n_b, b_x, b_y)`` bucket logits (the test oracle); ``use_kernel`` runs
the selection through ``kernels.ops.mips_topk`` and the in-bucket loss
through ``kernels.ops.sce_gather_loss``, which gathers the candidate rows
itself — on a CUDA tensor both are the hand-written kernels.

Random draws take an explicit ``torch.Generator``; ``omega=`` injects a
draw instead, so a test can hand the reference's Ω to both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops as _kops
from repro_torch.kernels.topk_merge import ID_PAD, NEG_INF, streaming_topk_elements


@dataclasses.dataclass(frozen=True)
class SCEConfig:
    """Hyperparameters of the SCE loss.

    The paper parametrises ``n_b`` and ``b_x`` by an oversampling factor
    ``alpha`` and a bucket shape factor ``beta`` (§4.2.1)::

        b_x = alpha * sqrt(N / beta),   n_b = alpha * sqrt(N * beta)

    so that ``n_b * b_x = alpha² * N`` and ``beta = n_b / b_x``.
    """

    n_buckets: int
    bucket_size_x: int
    bucket_size_y: int
    use_mix: bool = True
    use_kernel: bool = False
    # Final-logit soft-capping cap·tanh(logit/cap), applied to the
    # positive and the in-bucket negative logits, before the mask.
    logit_softcap: Optional[float] = None

    @staticmethod
    def from_alpha_beta(
        n_positions: int,
        catalog_size: int,
        *,
        alpha: float = 2.0,
        beta: float = 1.0,
        bucket_size_y: int = 256,
        use_mix: bool = True,
        use_kernel: bool = False,
    ) -> "SCEConfig":
        n_b = max(1, int(round(alpha * (n_positions * beta) ** 0.5)))
        b_x = max(1, int(round(alpha * (n_positions / beta) ** 0.5)))
        b_x = min(b_x, n_positions)
        b_y = min(bucket_size_y, catalog_size)
        return SCEConfig(
            n_buckets=n_b,
            bucket_size_x=b_x,
            bucket_size_y=b_y,
            use_mix=use_mix,
            use_kernel=use_kernel,
        )

    def logit_tensor_elements(self) -> int:
        """Size of the largest loss-side tensor (paper §3.1 memory model)."""
        return self.n_buckets * self.bucket_size_x * self.bucket_size_y


def make_bucket_centers(x, n_buckets: int, *, use_mix: bool,
                        valid_mask=None, generator=None, omega=None):
    """Bucket centres ``B`` (n_b, d), without a gradient.

    Without Mix ``B ~ N(0, 1)`` (Algorithm 1, line 2). With Mix
    ``B = Ω X / sqrt(N)`` with ``Ω ~ N(0, 1)^{n_b × N}``, drawn and
    accumulated in f32 whatever the training dtype, with padding
    positions (``valid_mask`` False) zeroed out of Ω. ``omega`` injects
    the draw (``(n_b, N)`` with Mix, ``(n_b, d)`` without); otherwise it
    comes from ``generator``.
    """
    xs = x.detach()
    if not use_mix:
        if omega is None:
            omega = torch.randn((n_buckets, xs.shape[-1]), generator=generator,
                                dtype=torch.float32, device=xs.device)
        return omega.to(xs.dtype)
    n = xs.shape[0]
    if omega is None:
        omega = torch.randn((n_buckets, n), generator=generator,
                            dtype=torch.float32, device=xs.device)
    if omega.shape != (n_buckets, n):
        raise ValueError(f"omega must be ({n_buckets}, {n}), got "
                         f"{tuple(omega.shape)}")
    omega = omega.to(device=xs.device, dtype=torch.float32)
    if valid_mask is not None:
        omega = omega * valid_mask[None, :].to(torch.float32)
    b = omega @ xs.to(torch.float32)
    b = b / torch.sqrt(torch.tensor(float(max(n, 1)), dtype=torch.float32,
                                    device=xs.device))
    return b.to(xs.dtype)


def _sanitize_placeholder_ids(idx, valid_mask):
    """Remap the streaming top-k's ``ID_PAD`` tail slots (rows with fewer
    valid columns than k) to the first masked position, so downstream
    gathers read an in-range row that ``valid_mask`` already excludes
    from coverage — where the dense path's ``NEG_INF`` tail lands too.
    A no-op when no placeholder occurs."""
    if valid_mask is None:
        return idx
    fallback = torch.argmin(valid_mask.to(torch.int32)).to(idx.dtype)
    return torch.where(idx == ID_PAD, fallback, idx)


def _dense_topk_ids(scores, k: int):
    """Ids of the top-``k`` entries along the last axis, ties to the lower
    index (the order of ``lax.top_k``): a stable descending sort, never
    ``torch.topk``, which promises no order among ties."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)


def select_buckets(b, x, y, cfg: SCEConfig, *, valid_mask=None):
    """Algorithm 1, lines 3–11: per-bucket top-``b_x`` positions (under
    ``valid_mask``) and top-``b_y`` catalog rows → ``(idx_x (n_b, b_x),
    idx_y (n_b, b_y))`` int32, without a gradient.

    With ``cfg.use_kernel`` both go through ``kernels.ops.mips_topk``
    (no ``(n_b, N)`` or ``(n_b, C)`` score matrix); the ids equal the
    dense path's wherever each row has ≥ k selectable columns, and the
    ``ID_PAD`` tail of a starved mask is remapped to the first masked
    position (:func:`_sanitize_placeholder_ids`).
    """
    xs = x.detach().contiguous()
    ys = y.detach().contiguous()
    b = b.contiguous()
    if cfg.use_kernel:
        valid = None if valid_mask is None else valid_mask.contiguous()
        _, idx_x = _kops.mips_topk(b, xs, cfg.bucket_size_x, valid=valid)
        idx_x = _sanitize_placeholder_ids(idx_x, valid_mask)
        _, idx_y = _kops.mips_topk(b, ys, cfg.bucket_size_y)
        return idx_x, idx_y
    xp = b @ xs.T  # (n_b, N)
    if valid_mask is not None:
        xp = torch.where(valid_mask[None, :], xp, NEG_INF)
    yp = b @ ys.T  # (n_b, C)
    return (_dense_topk_ids(xp, cfg.bucket_size_x),
            _dense_topk_ids(yp, cfg.bucket_size_y))


def apply_softcap(logits, cap: Optional[float]):
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _in_bucket_losses(x_b, y_b, tgt_b, cand_ids, pos_logit, softcap=None):
    """Algorithm 1, lines 12–15 on the plain path: materialises the
    ``(n_b, b_x, b_y)`` bucket logits, masks candidates equal to the
    position's positive, and returns the per-(bucket, position) CE."""
    neg = torch.einsum("nxd,nyd->nxy", x_b, y_b)
    neg = apply_softcap(neg, softcap)
    collide = cand_ids[:, None, :] == tgt_b[:, :, None]
    neg = torch.where(collide, NEG_INF, neg)
    all_logits = torch.cat([pos_logit[..., None], neg], dim=-1)
    return torch.logsumexp(all_logits, dim=-1) - pos_logit


def per_position_max(losses, idx_x, n_positions: int, *, valid_mask=None):
    """Algorithm 1, line 16: per position the largest loss over the
    buckets that hold it → ``(per_pos (N,), covered (N,) bool)``, with
    ``per_pos`` 0 off the covered (selected and valid) positions. Ties
    between buckets split the gradient evenly, as ``jax.ops.segment_max``
    does."""
    flat_idx = idx_x.reshape(-1).long()
    flat_loss = losses.reshape(-1)
    per_pos = torch.zeros(n_positions, dtype=flat_loss.dtype,
                          device=flat_loss.device)
    per_pos = per_pos.scatter_reduce(0, flat_idx, flat_loss, "amax",
                                     include_self=False)
    covered = torch.zeros(n_positions, dtype=torch.bool,
                          device=flat_loss.device)
    covered[flat_idx] = True
    if valid_mask is not None:
        covered = covered & valid_mask
    return torch.where(covered, per_pos, torch.zeros_like(per_pos)), covered


def aggregate_bucket_losses(losses, idx_x, n_positions: int, *,
                            valid_mask=None):
    """Algorithm 1, lines 16–17: :func:`per_position_max`, then the mean
    over covered positions → ``(loss, covered (N,) bool)``."""
    per_pos, covered = per_position_max(losses, idx_x, n_positions,
                                        valid_mask=valid_mask)
    denom = torch.clamp(covered.to(per_pos.dtype).sum(), min=1.0)
    return per_pos.sum() / denom, covered


def sce_loss(x, y, targets, *, cfg: SCEConfig, valid_mask=None,
             generator=None, omega=None, return_aux: bool = False,
             mark=None):
    """Scalable Cross-Entropy loss (Algorithm 1 + optional Mix).

    Parameters
    ----------
    x : (N, d) model outputs (batch × sequence, flattened).
    y : (C, d) catalog embeddings.
    targets : (N,) int — the correct item per position.
    cfg : :class:`SCEConfig`.
    valid_mask : optional (N,) bool; padding positions are left out of
        the selection and of the mean.
    generator : the ``torch.Generator`` the bucket centres are drawn
        from (a fresh draw per step).
    omega : optional injected draw, see :func:`make_bucket_centers`.
    return_aux : also return the selection diagnostics (paper Fig. 4).
    mark : optional callable, called with ``"select"`` where the bucket
        centres and the selection end and with ``"loss_forward"`` where
        the in-bucket loss and its aggregation end (to time the phases).

    Returns
    -------
    The scalar loss, and with ``return_aux`` a dict of diagnostics.
    """
    n = x.shape[0]
    b = make_bucket_centers(x, cfg.n_buckets, use_mix=cfg.use_mix,
                            valid_mask=valid_mask, generator=generator,
                            omega=omega)
    idx_x, idx_y = select_buckets(b, x, y, cfg, valid_mask=valid_mask)
    if mark:
        mark("select")

    ix = idx_x.long()
    x_b = x[ix]  # (n_b, b_x, d)
    tgt_b = targets[ix].to(torch.int32)  # (n_b, b_x)
    pos_emb = y[tgt_b.long()]  # (n_b, b_x, d)
    pos_logit = apply_softcap(torch.einsum("nxd,nxd->nx", x_b, pos_emb),
                              cfg.logit_softcap)
    if cfg.use_kernel:
        # The candidate rows y[idx_y] are gathered inside the kernel; the
        # positive arrives capped, its tanh derivative flows through the
        # einsum above by the kernel's d_pos cotangent.
        losses = _kops.sce_gather_loss(
            x_b.contiguous(), y, idx_y, tgt_b, idx_y,
            pos_logit.contiguous(), logit_softcap=cfg.logit_softcap,
        )
    else:
        y_b = y[idx_y.long()]  # (n_b, b_y, d)
        losses = _in_bucket_losses(x_b, y_b, tgt_b, idx_y, pos_logit,
                                   softcap=cfg.logit_softcap)

    loss, covered = aggregate_bucket_losses(losses, idx_x, n,
                                            valid_mask=valid_mask)
    if mark:
        mark("loss_forward")
    if not return_aux:
        return loss

    # Diagnostics (paper Fig. 4a/4b).
    flat = ix.reshape(-1)
    counts = torch.zeros(n, dtype=torch.int32, device=x.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    n_selected = (counts > 0).sum()
    unique_frac = (counts == 1).sum() / torch.clamp(n_selected, min=1)
    collide = idx_y[:, None, :] == tgt_b[:, :, None]  # (n_b, b_x, b_y)
    correct_frac = collide.any(dim=-1).sum() / flat.shape[0]
    aux = {
        "covered_frac": covered.to(torch.float32).mean(),
        "unique_selection_frac": unique_frac,
        "correct_class_logit_frac": correct_frac,
        "n_selected": n_selected,
    }
    return loss, aux


def sce_peak_elements(cfg: SCEConfig, n_positions: int, catalog: int,
                      d_model: int, *, fused: bool = False,
                      block_c: int = 512, block_by: int = 256) -> dict:
    """Analytic peak loss-side elements per pipeline stage (the
    reference's model, copied).

    ``fused=False``: the plain path — dense selection scores, gathered
    candidates and their cotangent, bucket logits. ``fused=True``: the
    kernel path — one streamed score tile plus the ``(n_b, 2k)`` merge
    buffers for the selection, one gathered candidate tile, and the
    ``(n_b, b_x)`` loss and lse rows; the candidates and their
    gradients never exist (dY lands in the parameter gradient).
    Returns the per-stage counts and ``"total"``.
    """
    n_b = cfg.n_buckets
    b_x = min(cfg.bucket_size_x, n_positions)
    b_y = min(cfg.bucket_size_y, catalog)
    if fused:
        k = max(b_x, b_y)
        out = {
            "selection_scores": streaming_topk_elements(n_b, k, block_c),
            "candidate_embeddings": min(block_by, b_y) * d_model,
            "candidate_grads": 0,
            "bucket_logits": 2 * n_b * b_x,
        }
    else:
        out = {
            "selection_scores": n_b * max(n_positions, catalog),
            "candidate_embeddings": n_b * b_y * d_model,
            "candidate_grads": n_b * b_y * d_model,
            "bucket_logits": n_b * b_x * b_y,
        }
    out["total"] = sum(out.values())
    return out


def sce_loss_memory_bytes(cfg: SCEConfig, dtype_bytes: int = 4, *,
                          n_positions: Optional[int] = None,
                          catalog: Optional[int] = None,
                          d_model: Optional[int] = None,
                          fused: bool = False) -> int:
    """Analytic peak bytes of the loss-side tensors: without shape
    arguments the paper's §3.1 model (the bucket-logit tensor only); with
    them the whole-pipeline peak of :func:`sce_peak_elements`."""
    if n_positions is None:
        return cfg.logit_tensor_elements() * dtype_bytes
    if catalog is None or d_model is None:
        raise ValueError("n_positions needs catalog and d_model too")
    return sce_peak_elements(cfg, n_positions, catalog, d_model,
                             fused=fused)["total"] * dtype_bytes


def full_ce_memory_bytes(n_positions: int, catalog: int,
                         dtype_bytes: int = 4) -> int:
    return n_positions * catalog * dtype_bytes
