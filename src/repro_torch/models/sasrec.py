"""SASRec — the SCE paper's backbone (port of ``repro/models/sasrec.py``):
item + learned positional embeddings, causal self-attention blocks,
LayerNorm, a tanh-GELU FFN; items are scored by the inner product of the
last hidden state with the item-embedding table. The same encoder with
``causal=False`` and a [MASK] row is BERT4Rec (``models/bert4rec.py``).

Parameters are a plain dict of tensors in the reference's layout
(``item_emb``, ``pos_emb``, ``ln_f_g``, ``ln_f_b`` and ``layers`` whose
leaves are stacked ``(n_layers, …)``, matmul weights ``(d_in, d_out)``),
so ``models/convert.py`` copies a JAX pytree across without reshaping.
The forward has no dropout: no train step of the reference passes a
dropout key, and parity runs keep it off.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, take_rows
from repro_torch.models.layers import (
    attention,
    dense_init,
    embed_init,
    layer_norm,
)


@dataclasses.dataclass(frozen=True)
class SeqRecConfig:
    n_items: int  # catalog size C (item ids 1..C-1; 0 = padding)
    max_len: int
    d_model: int
    n_layers: int = 2
    n_heads: int = 2
    d_ff: int = 0  # 0 → 4*d_model
    dropout: float = 0.2
    causal: bool = True  # False for BERT4Rec
    n_extra_tokens: int = 0  # e.g. 1 for BERT4Rec's [MASK]
    dtype: str = "float32"
    # Embedding rows padded so the vocab-parallel catalog shards evenly.
    row_pad_multiple: int = 16

    @property
    def n_rows(self) -> int:
        """Physical embedding rows: items + extra tokens, padded."""
        m = self.row_pad_multiple
        return -(-(self.n_items + self.n_extra_tokens) // m) * m

    @property
    def catalog_loss_size(self) -> int:
        """The shard-even catalog slice: the smallest multiple of
        ``row_pad_multiple`` ≥ ``n_items`` (may hold phantom rows)."""
        m = self.row_pad_multiple
        c = -(-self.n_items // m) * m
        return min(c, self.n_rows)

    @property
    def d_ff_actual(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} % n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


Params = Dict[str, object]


def init_params(cfg: SeqRecConfig, *, seed: int = 0,
                device=None) -> Params:
    """Random parameters from ``seed`` (a CPU ``torch.Generator``, so
    the same seed gives the same weights on every device), on ``device``:
    ``cuda`` unless given (raises without CUDA)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.torch_dtype
    d, ff, n = cfg.d_model, cfg.d_ff_actual, cfg.n_layers

    def stack(shape):
        return torch.stack([
            dense_init(gen, shape, dtype=dt, device=device) for _ in range(n)
        ])

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=device)

    layers = {
        "wqkv": stack((d, 3 * d)),
        "wo": stack((d, d)),
        "w1": stack((d, ff)),
        "w2": stack((ff, d)),
        "b1": full((n, ff), 0.0),
        "b2": full((n, d), 0.0),
        "ln1_g": full((n, d), 1.0),
        "ln1_b": full((n, d), 0.0),
        "ln2_g": full((n, d), 1.0),
        "ln2_b": full((n, d), 0.0),
    }
    return {
        "item_emb": embed_init(gen, (cfg.n_rows, d), dtype=dt, device=device),
        "pos_emb": embed_init(gen, (cfg.max_len, d), dtype=dt, device=device),
        "ln_f_g": full((d,), 1.0),
        "ln_f_b": full((d,), 0.0),
        "layers": layers,
    }


def forward(params: Params, cfg: SeqRecConfig, tokens) -> torch.Tensor:
    """Hidden states (B, L, D) of ``tokens`` (B, L) item ids (0 =
    padding): causal attention, or bidirectional for ``cfg.causal =
    False`` (BERT4Rec, ``models/bert4rec.py``). Padded positions are
    attended like any other (the reference has no key-padding mask);
    callers mask them downstream."""
    b, l = tokens.shape
    x = take_rows(params["item_emb"], tokens)
    x = x * cfg.d_model**0.5
    x = x + params["pos_emb"][None, :l]
    lp_all = params["layers"]
    h_, dh = cfg.n_heads, cfg.head_dim
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in lp_all.items()}
        h = layer_norm(x, lp["ln1_g"], lp["ln1_b"])
        q, k, v = (h @ lp["wqkv"]).split(cfg.d_model, dim=-1)
        o = attention(
            q.reshape(b, l, h_, dh), k.reshape(b, l, h_, dh),
            v.reshape(b, l, h_, dh), causal=cfg.causal,
        )
        x = x + o.reshape(b, l, cfg.d_model) @ lp["wo"]
        h2 = layer_norm(x, lp["ln2_g"], lp["ln2_b"])
        f = F.gelu(h2 @ lp["w1"] + lp["b1"], approximate="tanh")
        x = x + (f @ lp["w2"] + lp["b2"])
    return layer_norm(x, params["ln_f_g"], params["ln_f_b"])


def item_embeddings(params: Params, cfg: SeqRecConfig) -> torch.Tensor:
    """Exact catalog table Y (C, D)."""
    return params["item_emb"][: cfg.n_items]


def loss_catalog(params: Params, cfg: SeqRecConfig) -> torch.Tensor:
    """Shard-even catalog slice ``item_emb[:catalog_loss_size]`` (may
    hold phantom rows ``>= n_items``; serving masks them)."""
    return params["item_emb"][: cfg.catalog_loss_size]


def score_all(params: Params, cfg: SeqRecConfig, hidden) -> torch.Tensor:
    """Full-catalog scores ``hidden @ Yᵀ`` — evaluation only."""
    return hidden @ item_embeddings(params, cfg).T
