"""Shared layers (port of the subset of ``repro/models/layers.py`` that
SASRec uses).

Weights keep the reference's layout: matmul weights are ``(d_in,
d_out)`` and applied as ``x @ w``, tables are ``(rows, d)``. Random
draws come from an explicit ``torch.Generator`` on the CPU and are then
moved to the target device, so a seed gives the same weights on the CPU
and on the card (not the JAX package's weights: the two frameworks'
generators differ; tests hand both sides the same numpy arrays).
"""
from __future__ import annotations

from typing import Sequence

import torch

NEG_INF = -1e30


def dense_init(gen: torch.Generator, shape: Sequence[int], *,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style): N(0, 1) cut at ±2,
    times ``1/sqrt(fan_in)``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    w = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w / max(fan_in, 1) ** 0.5).to(dtype=dtype, device=device)


def embed_init(gen: torch.Generator, shape: Sequence[int], *,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """N(0, 0.02²) embedding-table init."""
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return (w * 0.02).to(dtype=dtype, device=device)


def layer_norm(x, gamma, beta, eps: float = 1e-6):
    """LayerNorm over the last axis in f32, with the reference's
    ``eps=1e-6`` (PyTorch's default is 1e-5)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * gamma.to(torch.float32) + beta.to(torch.float32)
    return out.to(dtype)


def attention(q, k, v, *, causal: bool = True):
    """Multi-head attention, the reference's short-query path
    (``Lq <= q_chunk``; grouped heads with ``Hkv == Hq`` here).

    q, k, v : (B, L, H, dh). The causal mask fills with ``NEG_INF``
    (-1e30, not -inf), exactly as the reference; there is no key-padding
    mask. Scores and the weighted sum are f32. → (B, L, H, dh).
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)
    ) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        pos_q = torch.arange(lq, device=q.device)
        pos_k = torch.arange(lk, device=q.device)
        mask = pos_k[None, :] <= pos_q[:, None]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)
