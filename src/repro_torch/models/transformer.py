"""Decoder-only transformer LM (port of ``repro/models/transformer.py``,
llama / gemma-style, plain PyTorch).

What the registered archs use: GQA, RoPE, SwiGLU, RMSNorm with a
``1 + γ`` gain; gemma-2's alternating local (sliding-window) and global
attention, attention and final-logit softcaps, post-block norms, tied
embeddings scaled by ``sqrt(d_model)``; the MoE FFN of granite and
kimi-k2 (``models/moe.py``, ``cfg.moe``) in place of the dense SwiGLU;
a decode path over a dense KV cache whose local layers keep a rolling
``window``-sized cache.

Parameters are a plain dict in the reference's layout — ``embed``
(V_pad, d), ``norm_final`` (d,), optionally ``unembed``, and ``layers``
whose leaves are stacked ``(n_layers, …)`` with matmul weights
``(d_in, d_out)`` (``mlp`` holding ``w_gate``, ``w_up``, ``w_down``; an
MoE model's ``moe`` holding ``router``, the experts' ``w_gate``,
``w_up``, ``w_down`` and optionally ``shared``) — so
``models/convert.py`` copies a JAX pytree across without reshaping.
The layers run in groups of ``len(attn_pattern)`` (one local and one
global layer for gemma-2), each group checkpointed
(``torch.utils.checkpoint``) when ``cfg.remat`` is set and gradients
are on: the backward recomputes a group from its input, which is what
lets gemma-2 train at full width on one card.

``forward`` returns the final hidden states, not logits: the loss
decides how to touch the vocabulary (SCE, or the streamed full CE).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, take_rows
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    NEG_INF,
    apply_rope,
    dense_init,
    embed_init,
    gqa_attention,
    init_swiglu,
    rms_norm,
    swiglu,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    rope_theta: float = 10000.0
    # attention pattern, tiled over layers: ("global",) or ("local","global")
    attn_pattern: Tuple[str, ...] = ("global",)
    window: Optional[int] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    use_post_norm: bool = False  # gemma-2 style post-block norms
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma-style sqrt(d_model) scaling
    moe: Optional[moe_lib.MoEConfig] = None
    dtype: str = "float32"
    remat: bool = True
    q_chunk: int = 1024
    # Embedding rows padded so the vocab-parallel table shards evenly;
    # the padded rows are phantom ids (never targets, masked at serve).
    vocab_pad_multiple: int = 16

    def __post_init__(self):
        if self.n_layers % len(self.attn_pattern):
            raise ValueError("n_layers must be a multiple of the attention "
                             "pattern length")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def n_heads_padded(self) -> int:
        """Query heads padded per kv-group so the head axis tiles a
        16-way model axis (56 → 64, 24 → 32), as in the reference;
        unchanged below 16 heads or at a multiple of 16."""
        if self.n_heads < 16 or self.n_heads % 16 == 0:
            return self.n_heads
        g = self.n_heads // self.n_kv_heads
        g_pad = g
        while (self.n_kv_heads * g_pad) % 16 != 0:
            g_pad += 1
        return self.n_kv_heads * g_pad

    @property
    def group_size(self) -> int:
        return len(self.attn_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.group_size

    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        hp = self.n_heads_padded
        attn = d * (hp + 2 * self.n_kv_heads) * dh + hp * dh * d
        if self.moe is not None:
            m = self.moe
            ffn = m.n_experts * 3 * d * m.d_ff + d * m.n_experts
            ffn += m.n_shared_experts * 3 * d * m.d_ff
        else:
            ffn = 3 * d * self.d_ff
        norms = (4 if self.use_post_norm else 2) * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn + norms) + emb + d

    def active_param_count(self) -> int:
        """Parameters a token uses (MoE: its top_k and the shared experts
        only), as the reference counts them."""
        if self.moe is None:
            return self.param_count()
        m, d = self.moe, self.d_model
        all_experts = self.n_layers * m.n_experts * 3 * d * m.d_ff
        active = (self.n_layers * (m.top_k + m.n_shared_experts)
                  * 3 * d * m.d_ff)
        return self.param_count() - all_experts + active


Params = dict


def init_params(cfg: TransformerConfig, *, seed: int = 0,
                device=None) -> Params:
    """Random parameters from ``seed`` on ``device`` (``cuda`` unless
    given; raises without CUDA), drawn there by a ``torch.Generator`` of
    that device: truncated-normal fan-in matmul weights, N(0, 0.02²)
    tables, zero norm gains (the ``1 + γ`` RMSNorm); an MoE model's
    layers take ``moe_lib.init_moe``'s weights in place of the SwiGLU's.
    The same seed gives the same weights on the same kind of device."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.torch_dtype
    d, dh, hq, hkv, ff, n = (cfg.d_model, cfg.head_dim, cfg.n_heads_padded,
                             cfg.n_kv_heads, cfg.d_ff, cfg.n_layers)

    def stacked(shape, init=dense_init):
        w = torch.empty((n,) + shape, dtype=dt, device=device)
        for i in range(n):  # each layer's fan-in is its own shape's
            w[i] = init(gen, shape, dtype=dt, device=device)
        return w

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    layers = {
        "wq": stacked((d, hq * dh)),
        "wk": stacked((d, hkv * dh)),
        "wv": stacked((d, hkv * dh)),
        "wo": stacked((hq * dh, d)),
        "norm_attn": zeros(n, d),
        "norm_mlp": zeros(n, d),
    }
    if cfg.use_post_norm:
        layers["norm_attn_post"] = zeros(n, d)
        layers["norm_mlp_post"] = zeros(n, d)
    if cfg.moe is not None:
        per_layer = [moe_lib.init_moe(gen, d, cfg.moe, dtype=dt,
                                      device=device) for _ in range(n)]
        layers["moe"] = _stack(per_layer)
    else:
        per_layer = [init_swiglu(gen, d, ff, dtype=dt, device=device)
                     for _ in range(n)]
        layers["mlp"] = _stack(per_layer)
    del per_layer
    params = {
        "embed": embed_init(gen, (cfg.vocab_padded, d), dtype=dt,
                            device=device),
        "norm_final": zeros(d),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, (cfg.vocab_padded, d), dtype=dt,
                                       device=device)
    return params


def output_embedding(params, cfg: TransformerConfig):
    """The full (padded) output table; the training losses treat the
    padded rows as phantom negatives."""
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _stack(trees):
    """Per-layer nested dicts of tensors → one dict of stacked leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


def _layer(params, i: int):
    """Layer ``i``'s slice of the stacked layer parameters."""
    return _slice(params["layers"], i)


def _embed(params, cfg: TransformerConfig, tokens):
    x = take_rows(params["embed"], tokens)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _qkv(cfg: TransformerConfig, x, lp, positions):
    b, l, _ = x.shape
    h = rms_norm(x, lp["norm_attn"])
    q = (h @ lp["wq"]).reshape(b, l, cfg.n_heads_padded, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _attn_out(cfg: TransformerConfig, out, lp):
    b, l = out.shape[:2]
    out = out.reshape(b, l, cfg.n_heads_padded * cfg.head_dim) @ lp["wo"]
    if cfg.use_post_norm:
        out = rms_norm(out, lp["norm_attn_post"])
    return out


def _mlp_block(cfg: TransformerConfig, x, lp):
    """The FFN block → ``(out, aux)``: the dense SwiGLU (aux a 0-d f32
    zero) or the MoE FFN with its balance loss."""
    h = rms_norm(x, lp["norm_mlp"])
    if cfg.moe is not None:
        out, aux = moe_lib.apply_moe(lp["moe"], h, cfg.moe)
    else:
        out = swiglu(lp["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.use_post_norm:
        out = rms_norm(out, lp["norm_mlp_post"])
    return out, aux


def _window(cfg: TransformerConfig, layer_type: str):
    return cfg.window if layer_type == "local" else None


def forward(params, cfg: TransformerConfig, tokens,
            positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, L) int → ``(hidden (B, L, d), aux_loss)``; ``aux_loss``
    is the MoE balance loss summed over the layers, in f32 (a 0-d zero
    for the dense archs), as the reference's scan sums it."""
    b, l = tokens.shape
    if positions is None:
        positions = torch.arange(l, device=tokens.device)[None, :]
    x = _embed(params, cfg, tokens)

    def group(x, g):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, layer_type in enumerate(cfg.attn_pattern):
            lp = _layer(params, g * cfg.group_size + gi)
            q, k, v = _qkv(cfg, x, lp, positions)
            out = gqa_attention(q, k, v, causal=True,
                                window=_window(cfg, layer_type),
                                softcap=cfg.attn_softcap,
                                q_chunk=cfg.q_chunk)
            x = x + _attn_out(cfg, out, lp)
            mlp_out, aux = _mlp_block(cfg, x, lp)
            x = x + mlp_out
            aux_total = aux_total + aux
        return x, aux_total

    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for g in range(cfg.n_groups):
        x, aux = (checkpoint(group, x, g, use_reentrant=False) if remat
                  else group(x, g))
        auxes.append(aux)
    x = rms_norm(x, params["norm_final"])
    return x, torch.stack(auxes).sum()


def logits_from_hidden(params, cfg: TransformerConfig, hidden):
    """Full logits (decode, small vocabularies): ``hidden @ embedᵀ``,
    softcapped; the phantom padded rows at −1e30."""
    logits = hidden @ output_embedding(params, cfg).T
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab:
        ids = torch.arange(cfg.vocab_padded, device=logits.device)
        logits = torch.where(ids < cfg.vocab, logits, NEG_INF)
    return logits


def _to_cache(cfg: TransformerConfig, kv, layer_type: str, cache_len: int):
    """(B, S, Hkv, dh) → one layer's cache: a global layer keeps the
    first ``cache_len`` positions (zero-padded); a local one the last
    ``min(window, cache_len)`` at slots ``p mod w``."""
    s = kv.shape[1]
    if layer_type == "local" and cfg.window is not None:
        w = min(cfg.window, cache_len)
        if s >= w:
            rel = (torch.arange(w, device=kv.device) - s) % w
            return kv[:, s - w:s][:, rel]
        return torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, w - s))
    if s >= cache_len:
        return kv[:, :cache_len]
    return torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, cache_len - s))


@torch.no_grad()
def prefill(params, cfg: TransformerConfig, tokens, *,
            cache_len: Optional[int] = None):
    """A full prompt → ``(hidden (B, S, d), cache)``, the cache in
    :func:`init_cache`'s layout (``k{gi}`` / ``v{gi}`` stacked over the
    layer groups): global layers keep ``cache_len`` (default: the prompt
    length) positions, local layers the last ``window`` at slots
    ``p mod window`` — what :func:`decode_step` continues from at
    ``pos = S``."""
    b, s = tokens.shape
    cache_len = cache_len or s
    positions = torch.arange(s, device=tokens.device)[None, :]
    x = _embed(params, cfg, tokens)
    caches = {f"{kind}{gi}": [] for gi in range(cfg.group_size)
              for kind in "kv"}
    for g in range(cfg.n_groups):
        for gi, layer_type in enumerate(cfg.attn_pattern):
            lp = _layer(params, g * cfg.group_size + gi)
            q, k, v = _qkv(cfg, x, lp, positions)
            out = gqa_attention(q, k, v, causal=True,
                                window=_window(cfg, layer_type),
                                softcap=cfg.attn_softcap,
                                q_chunk=cfg.q_chunk)
            x = x + _attn_out(cfg, out, lp)
            x = x + _mlp_block(cfg, x, lp)[0]
            caches[f"k{gi}"].append(_to_cache(cfg, k, layer_type, cache_len))
            caches[f"v{gi}"].append(_to_cache(cfg, v, layer_type, cache_len))
    x = rms_norm(x, params["norm_final"])
    return x, {name: torch.stack(c) for name, c in caches.items()}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device=None):
    """Dense KV cache, ``k{gi}`` / ``v{gi}`` of shape (n_groups, B, len,
    H_kv, dh): ``max_len`` for global layers, ``min(window, max_len)``
    for local ones (a rolling cache)."""
    dtype = dtype or cfg.torch_dtype
    caches = {}
    for gi, layer_type in enumerate(cfg.attn_pattern):
        length = (min(cfg.window, max_len)
                  if layer_type == "local" and cfg.window is not None
                  else max_len)
        shape = (cfg.n_groups, batch, length, cfg.n_kv_heads, cfg.head_dim)
        caches[f"k{gi}"] = torch.zeros(shape, dtype=dtype, device=device)
        caches[f"v{gi}"] = torch.zeros(shape, dtype=dtype, device=device)
    return caches


@torch.no_grad()
def decode_step(params, cfg: TransformerConfig, cache, tokens, pos: int):
    """One decode step: tokens (B, 1) at position ``pos`` → ``(logits
    (B, 1, V_pad), new_cache)``. Global layers mask the slots past
    ``pos``; local layers write slot ``pos mod len`` of their rolling
    cache and, until it has filled, mask the unfilled slots. The cache
    passed in is left as it was."""
    b = tokens.shape[0]
    x = _embed(params, cfg, tokens)
    positions = torch.full((b, 1), pos, device=tokens.device)
    new = {name: c.clone() for name, c in cache.items()}
    for g in range(cfg.n_groups):
        for gi, layer_type in enumerate(cfg.attn_pattern):
            lp = _layer(params, g * cfg.group_size + gi)
            k_cache, v_cache = new[f"k{gi}"][g], new[f"v{gi}"][g]
            cache_len = k_cache.shape[1]
            local = layer_type == "local" and cfg.window is not None
            slot = pos % cache_len if local else pos
            q, k_new, v_new = _qkv(cfg, x, lp, positions)
            k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
            v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)
            kv_idx = torch.arange(cache_len, device=tokens.device)
            valid = kv_idx <= pos
            if local and pos >= cache_len:
                valid = torch.ones_like(valid)
            out = gqa_attention(q, k_cache, v_cache, causal=False,
                                softcap=cfg.attn_softcap,
                                kv_valid=valid[None, :].expand(b, -1))
            x = x + _attn_out(cfg, out, lp)
            x = x + _mlp_block(cfg, x, lp)[0]
    x = rms_norm(x, params["norm_final"])
    return logits_from_hidden(params, cfg, x), new
