"""BERT4Rec (Sun et al. 2019) — a bidirectional encoder over item
sequences trained with masked-item prediction, the Cloze objective (port
of ``repro/models/bert4rec.py``).

It is the SeqRec encoder of ``models/sasrec.py`` with ``causal=False``
and one extra embedding row, the [MASK] token (id ``n_items``). The
masked-position CE over the catalog is the loss the SCE paper targets: at
the published 10⁶-item catalog (``configs/bert4rec.py``) this model is
the showcase of the technique.

The cloze mask is drawn from an explicit ``torch.Generator``, or the
caller injects the uniform draw (the parity tests hand both packages the
same numbers).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.sasrec import Params, SeqRecConfig
from repro_torch.models.sasrec import forward as _encoder_forward
from repro_torch.models.sasrec import init_params as _init_params


def make_config(n_items: int, max_len: int = 200, d_model: int = 64,
                n_layers: int = 2, n_heads: int = 2, dropout: float = 0.1,
                dtype: str = "float32") -> SeqRecConfig:
    return SeqRecConfig(
        n_items=n_items, max_len=max_len, d_model=d_model,
        n_layers=n_layers, n_heads=n_heads, dropout=dropout, causal=False,
        n_extra_tokens=1,  # [MASK]
        dtype=dtype,
    )


def mask_token_id(cfg: SeqRecConfig) -> int:
    return cfg.n_items  # the extra embedding row


def init_params(cfg: SeqRecConfig, *, seed: int = 0, device=None) -> Params:
    """Random parameters from ``seed`` (``models/sasrec.py::init_params``:
    the item table has ``cfg.n_rows`` rows, the [MASK] row among them)."""
    return _init_params(cfg, seed=seed, device=device)


def apply_cloze_mask(tokens: torch.Tensor, cfg: SeqRecConfig, *,
                     mask_prob: float = 0.15,
                     generator: Optional[torch.Generator] = None,
                     uniform: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace items with [MASK] where a uniform draw is below
    ``mask_prob`` → ``(masked_tokens, is_masked)``. Padding (id 0) is never
    masked. The draw is ``uniform`` when given (a float tensor of
    ``tokens``' shape), else drawn from ``generator`` on ``tokens``'
    device."""
    if uniform is None:
        uniform = torch.rand(tokens.shape, generator=generator,
                             device=tokens.device)
    elif uniform.shape != tokens.shape:
        raise ValueError(f"uniform {tuple(uniform.shape)} for tokens "
                         f"{tuple(tokens.shape)}")
    is_masked = (uniform < mask_prob) & (tokens != 0)
    masked = torch.where(is_masked, torch.full_like(tokens,
                                                    mask_token_id(cfg)),
                         tokens)
    return masked, is_masked


def forward(params: Params, cfg: SeqRecConfig, tokens) -> torch.Tensor:
    """tokens: (B, L), already cloze-masked for training → (B, L, D)."""
    return _encoder_forward(params, cfg, tokens)


def item_embeddings(params: Params, cfg: SeqRecConfig) -> torch.Tensor:
    return params["item_emb"][: cfg.n_items]


def retrieval_scores(params: Params, cfg: SeqRecConfig, hidden_state,
                     candidate_ids) -> torch.Tensor:
    """One (or few) user states ``(B, D)`` against a candidate list
    ``(N_cand,)`` → ``(B, N_cand)`` dense scores, one product (the plain
    form of ``launch/steps.py::make_seqrec_retrieval_step``)."""
    cand = params["item_emb"][candidate_ids.long()]
    return hidden_state @ cand.T
