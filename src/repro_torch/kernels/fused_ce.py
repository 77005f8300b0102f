"""Full-catalog logsumexp streamed over the catalog, on the H100 (port of
``fused_lse`` / ``fused_ce_loss`` of ``repro/kernels/fused_ce.py``).

The kernels are ``csrc/linear_ce.cu``'s, launched without the in-sweep
positive, the one-hot and the softcap (``kernels/linear_sce.py``'s
``_fwd``, ``_dx`` and ``_dw``, on the planes of its
``linear_ce_split``; above d 256 its deep entries, on no planes).
Three wrappers, each with its own launch counter:

* :func:`fused_lse_fwd` — per-position lse (N,) f32;
* :func:`fused_lse_dx` — dX = ``(p·g) Y`` (N, d);
* :func:`fused_lse_dy` — dY = ``(p·g)ᵀ X`` (C, d), every row written once.

:class:`FusedLSE` ties them together for autograd (forward it splits
``x`` and ``y`` once into the planes all three kernels read and saves
them with the lse; backward the gradients recompute the tiles).
:func:`fused_ce_loss` is ``fused_lse − x·y[targets]``: the positive's
gradient comes from autograd through the gather, as in the reference.
CUDA tensors only; the CPU path is ``kernels/ref.py``, chosen by
``kernels/ops.py``. ``x`` and ``y`` f32 or both bfloat16, as
``linear_sce.py`` takes them; the lse is f32, dX and dY in the
operands' types.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import linear_sce as _linear


def fused_lse_fwd(x, y, *, planes=None):
    """Forward kernel: the (N,) f32 logsumexp of ``x @ yᵀ`` per row.
    Matches ``ref.fused_lse_ref``. ``planes``: ``linear_ce_split(x, y)``
    (split here when None)."""
    _, lse = _linear._fwd(x, y, None, None, planes)
    fused_lse_fwd.launches += 1
    return lse


def fused_lse_dx(x, y, lse, g, *, planes=None):
    """dX kernel: the (N, d) gradient of ``x`` for the cotangent ``g`` of
    the lse. ``planes``: ``linear_ce_split(x, y)`` (split here when
    None)."""
    dx = _linear._dx(x, y, None, lse, g, None, planes)
    fused_lse_dx.launches += 1
    return dx


def fused_lse_dy(x, y, lse, g, *, planes=None):
    """dY kernel: the (C, d) gradient of ``y``, each row written once."""
    dy = _linear._dw(x, y, None, lse, g, None, planes)
    fused_lse_dy.launches += 1
    return dy


fused_lse_fwd.launches = 0
fused_lse_dx.launches = 0
fused_lse_dy.launches = 0


class FusedLSE(torch.autograd.Function):
    """``lse (N,)`` of ``(x, y)``, differentiable in both."""

    @staticmethod
    def forward(ctx, x, y):
        planes = (() if _linear.is_deep(x.shape[-1])
                  else _linear.linear_ce_split(x, y))
        lse = fused_lse_fwd(x, y, planes=planes or None)
        ctx.save_for_backward(x, y, lse, *planes)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, y, lse, *planes = ctx.saved_tensors
        g = g.contiguous()
        need = ctx.needs_input_grad
        if _linear.is_deep(x.shape[-1]):  # one launch, G written once
            dx, dy = _linear._bwd_deep(x, y, None, lse, g, None, need[0],
                                       need[1])
            fused_lse_dx.launches += need[0]
            fused_lse_dy.launches += need[1]
            return dx, dy
        dx = fused_lse_dx(x, y, lse, g, planes=planes) if need[0] else None
        dy = fused_lse_dy(x, y, lse, g, planes=planes) if need[1] else None
        return dx, dy


def fused_lse(x, y):
    """Per-position full-catalog logsumexp (N,) on the card; the ``(N, C)``
    logits never exist, forward or backward."""
    return FusedLSE.apply(x.contiguous(), y.contiguous())


def fused_ce_loss(x, y, targets):
    """Per-position full CE ``lse(x·yᵀ) − x·y[targets]`` (N,) on the card,
    in ``x``'s type; the positive in f32 from the rows as stored, as the
    reference takes it (``fused_ce.py:271-276``)."""
    pos = torch.einsum("nd,nd->n", x.to(torch.float32),
                       y[targets.long()].to(torch.float32))
    return (fused_lse(x, y) - pos).to(x.dtype)
