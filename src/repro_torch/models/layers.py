"""Shared layers (port of ``repro/models/layers.py``: what SASRec, the
decoder-only transformer LM and the CTR models' MLPs use).

Weights keep the reference's layout: matmul weights are ``(d_in,
d_out)`` and applied as ``x @ w``, tables are ``(rows, d)``. Random
draws come from an explicit ``torch.Generator``, on the generator's
device, and are then moved to the target device: SASRec draws on the
CPU, so a seed gives the same weights on the CPU and on the card; the
LM draws on its own device (2.6 B values at gemma-2's width). Neither
gives the JAX package's weights: the two frameworks' generators differ;
tests hand both sides the same numpy arrays.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def dense_init(gen: torch.Generator, shape: Sequence[int], *,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style): N(0, 1) cut at ±2,
    times ``1/sqrt(fan_in)``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w / max(fan_in, 1) ** 0.5).to(dtype=dtype, device=device)


def embed_init(gen: torch.Generator, shape: Sequence[int], *,
               scale: float = 0.02, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """N(0, scale²) embedding-table init (0.02 by default)."""
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype=dtype, device=device)


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


# ---------------------------------------------------------------------------
# The transformer LM's layers
# ---------------------------------------------------------------------------
def rms_norm(x, gamma, eps: float = 1e-6):
    """RMSNorm over the last axis in f32, scaled by ``1 + gamma`` (the
    reference's zero-initialised gain)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + gamma.to(torch.float32))
    return out.to(dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """``1 / theta^(2i / head_dim)`` for i < head_dim / 2, f32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary embeddings on the two halves of the last axis.
    x: (..., L, H, dh); positions: broadcastable to (..., L)."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., L, dh/2)
    cos = torch.cos(angles)[..., None, :]  # (..., L, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(scores, cap: Optional[float]):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _attn_mask(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """(Lq, Lk) bool: which keys each query may see."""
    mask = torch.ones(q_pos.shape[0], kv_pos.shape[0], dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    return mask


def _attn_grouped(q, k, v, q_pos, kv_pos, *, causal, window, softcap,
                  kv_valid):
    """The short-query path: q (B, c, Hkv, G, dh) against k, v
    (B, Lk, Hkv, dh), heads grouped, scores f32."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bchgd,blhd->bchgl", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = _softcap(scores, softcap)
    mask = _attn_mask(q_pos, kv_pos, causal, window)
    scores = torch.where(mask[None, :, None, None, :], scores, NEG_INF)
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, None, :], scores,
                             NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bchgl,blhd->bchgd", probs.to(v.dtype), v)
    return out.to(v.dtype)


def _attn_flat(q, k, v, q_pos, kv_pos, *, causal, window, softcap,
               kv_valid):
    """The long-query path's chunk: q (B, c, Hq, dh) against k, v already
    expanded to the query heads, one flat head axis, scores f32."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bchd,blhd->bchl", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = _softcap(scores, softcap)
    mask = _attn_mask(q_pos, kv_pos, causal, window)
    scores = torch.where(mask[None, :, None, :], scores, NEG_INF)
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bchl,blhd->bchd", probs.to(v.dtype), v)
    return out.to(v.dtype)


def gqa_attention(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None, q_offset=0,
                  kv_valid=None, q_chunk: int = 1024):
    """Grouped-query attention, the reference's ``attention`` (plain
    PyTorch: SDPA takes no softcap). q (B, Lq, Hq, dh), k and v
    (B, Lk, Hkv, dh) with Hq a multiple of Hkv (query head h reads kv
    head h // (Hq / Hkv)). ``window``: a key at most ``window − 1``
    positions back; ``softcap``: ``cap·tanh(s / cap)`` before the mask;
    ``q_offset``: global position of q[0]; ``kv_valid`` (B, Lk) bool
    masks cache slots. Masked scores are ``NEG_INF`` (−1e30), softmax in
    f32. Up to ``q_chunk`` queries in one piece with grouped heads; above
    it (``Lq`` a multiple of ``q_chunk``) ``q_chunk`` queries at a time
    against k and v expanded to the query heads, each chunk checkpointed
    when gradients are on (its scores recomputed in the backward), so the
    score memory is one chunk's. → (B, Lq, Hq, dh)."""
    b, lq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    kv_pos = torch.arange(k.shape[1], device=q.device)
    q_pos = q_offset + torch.arange(lq, device=q.device)
    kw = dict(causal=causal, window=window, softcap=softcap,
              kv_valid=kv_valid)
    if lq <= q_chunk:
        out = _attn_grouped(q.reshape(b, lq, hkv, g, dh), k, v, q_pos,
                            kv_pos, **kw)
        return out.reshape(b, lq, hq, dh).to(q.dtype)
    if lq % q_chunk:
        raise ValueError(f"Lq={lq} is not a multiple of q_chunk={q_chunk}")
    if hkv != hq:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    chunk_fn = functools.partial(_attn_flat, **kw)
    outs = []
    for i in range(lq // q_chunk):
        sl = slice(i * q_chunk, (i + 1) * q_chunk)
        args = (q[:, sl], k, v, q_pos[sl], kv_pos)
        if torch.is_grad_enabled():
            outs.append(checkpoint(chunk_fn, *args, use_reentrant=False))
        else:
            outs.append(chunk_fn(*args))
    return torch.cat(outs, dim=1).to(q.dtype)


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, *,
                dtype=torch.float32, device=None):
    """SwiGLU weights ``w_gate``, ``w_up`` (d, ff) and ``w_down`` (ff, d)."""
    kw = dict(dtype=dtype, device=device)
    return {"w_gate": dense_init(gen, (d_model, d_ff), **kw),
            "w_up": dense_init(gen, (d_model, d_ff), **kw),
            "w_down": dense_init(gen, (d_ff, d_model), **kw)}


def swiglu(params, x):
    """``(silu(x @ w_gate) · (x @ w_up)) @ w_down``."""
    gate = F.silu(x @ params["w_gate"])
    return (gate * (x @ params["w_up"])) @ params["w_down"]


def init_mlp(gen: torch.Generator, sizes: Sequence[int], *,
             dtype=torch.float32, device=None):
    """A plain MLP's weights for ``sizes = (d_in, h1, …, d_out)``:
    ``w{i}`` (sizes[i], sizes[i + 1]) fan-in initialised, ``b{i}`` zero."""
    n = len(sizes) - 1
    out = {f"w{i}": dense_init(gen, (sizes[i], sizes[i + 1]), dtype=dtype,
                               device=device) for i in range(n)}
    out.update({f"b{i}": torch.zeros(sizes[i + 1], dtype=dtype,
                                     device=device) for i in range(n)})
    return out


def mlp_apply(params, x, activation=F.relu, final_activation=None):
    """``x`` through the MLP: ``activation`` (ReLU) between layers, and
    ``final_activation`` after the last one if given."""
    n = sum(1 for k in params if k.startswith("w"))
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x
