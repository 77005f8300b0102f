"""Gradient compression for the data-parallel reduction (port of
``repro/optim/compression.py``).

int8 linear quantization with one scale a leaf and error feedback (Seide
et al. 2014; Karimireddy et al. 2019): each step quantizes the gradient
plus the residual of the step before, hands the optimizer the
dequantized values and carries the new quantization error to the next
step, so the compressed trajectory tracks the exact one. The arithmetic
is the reference's: ``scale = max(max|x| / 127, 1e-12)`` in f32 and
round half to even (``torch.round`` as ``jnp.round``), so ``q``, the
scale and the residual equal its bits.

:func:`with_error_feedback_compression` wraps an ``(init, update)``
optimizer. The f32 residual rides inside the optimizer state as
``inner = {"base": <the wrapped optimizer's>, "ef": <residual tree>}``,
so a checkpoint sees one ordinary state tree. As in the reference, the
data-parallel gradient sum runs before the wrapper sees the gradients:
this models the quantization's effect on the trajectory, not a smaller
wire payload.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.optim.optimizers import (
    OptState,
    _write_where,
    tree_leaves,
    tree_map,
)


class ErrorFeedbackState(NamedTuple):
    residual: dict  # f32, the structure of the gradients


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric linear quantization to int8 → ``(q, scale)``, ``scale``
    a 0-d f32 tensor (``1e-12`` for an all-zero ``x``)."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def init_error_feedback(grads) -> ErrorFeedbackState:
    """Zero residuals in f32, one a leaf of ``grads``."""
    return ErrorFeedbackState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


@torch.no_grad()
def compressed_gradient_transform(grads, ef: ErrorFeedbackState):
    """Quantize ``grads + residual`` leaf by leaf → ``(dequantized
    gradients in each leaf's dtype, ErrorFeedbackState(new residual))``;
    the round trip models what would cross the wire."""
    def leaf(g, r):
        target = g.to(torch.float32) + r
        deq = decompress_int8(*compress_int8(target))
        return deq.to(g.dtype), target - deq

    out = tree_map(leaf, grads, ef.residual)
    return (tree_map(lambda t: t[0], out),
            ErrorFeedbackState(residual=tree_map(lambda t: t[1], out)))


def with_error_feedback_compression(opt):
    """Wrap an ``(init, update)`` optimizer so its gradients pass through
    int8 error-feedback compression first (module docstring). The wrapped
    ``update`` keeps the ``guarded_in_place`` form the trainers' guarded
    step runs: the wrapped optimizer's in-place update sees the
    dequantized gradients, and the residual is written where the 0-d
    ``ok`` holds (kept bit for bit on a skipped step, as the reference's
    ``where`` over the whole state keeps it)."""
    init0, update0 = opt

    def init(params) -> OptState:
        st = init0(params)
        return OptState(step=st.step, inner={
            "base": st.inner, "ef": init_error_feedback(params).residual})

    def update(grads, state: OptState, params):
        grads_c, ef = compressed_gradient_transform(
            grads, ErrorFeedbackState(residual=state.inner["ef"]))
        new_params, base = update0(
            grads_c, OptState(step=state.step, inner=state.inner["base"]),
            params)
        return new_params, OptState(step=base.step, inner={
            "base": base.inner, "ef": ef.residual})

    @torch.no_grad()
    def guarded_in_place(grads, state: OptState, params, ok):
        grads_c, ef = compressed_gradient_transform(
            grads, ErrorFeedbackState(residual=state.inner["ef"]))
        params, base = update0.guarded_in_place(
            grads_c, OptState(step=state.step, inner=state.inner["base"]),
            params, ok)
        for old, new in zip(tree_leaves(state.inner["ef"]),
                            tree_leaves(ef.residual)):
            _write_where(ok, new, old)
        return params, OptState(step=base.step, inner={
            "base": base.inner, "ef": state.inner["ef"]})

    update.guarded_in_place = guarded_in_place
    return init, update
