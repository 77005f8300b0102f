"""CTR / ranking models (port of ``repro/models/recsys.py``): DCN-v2,
DLRM, xDeepFM.

Shared substrate: sparse categorical features → one embedding table a
field (10⁶–10⁷ rows) → an EmbeddingBag lookup (a row gather and a sum,
:func:`embedding_bag`) → a feature-interaction op (cross, pairwise dot,
CIN) → MLP → one click logit a row.

  * DCN-v2  [arXiv:2008.13535]: full-rank cross layers ∥ deep MLP.
  * DLRM    [arXiv:1906.00091]: bottom MLP, pairwise-dot interaction,
            top MLP (RM2 sizing).
  * xDeepFM [arXiv:1803.05170]: CIN (outer product + field compression)
            ∥ DNN ∥ linear.

Parameters are plain dicts in the reference's layout: ``tables`` (and
xDeepFM's ``linear`` and ``cin_w``, DCN-v2's ``cross_w`` / ``cross_b``)
are lists, one entry a field or layer; matmul weights are ``(d_in,
d_out)``; MLPs are ``init_mlp``'s ``w{i}`` / ``b{i}``. So
``models/convert.py`` copies a JAX pytree across leaf for leaf.

None of this runs a Pallas kernel in the reference, and the port adds
no kernel: the gather is ``index_select`` (:func:`embedding_bag`), the
interactions are ``bmm`` / matmuls. The embedding gradients are dense, as the
reference's gradient of ``jnp.take`` is: the optimizer decays and moves
every row every step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    init_mlp,
    mlp_apply,
)

# Rows of xDeepFM's CIN at a time: its outer product is (rows, D, H, m),
# 1.25 GB in f32 at 4,096 rows and the published H 200, m 39, D 10
# (19 GiB a layer at the 65,536 rows of train_batch). Under autograd each
# block is recomputed in the backward instead of kept.
CIN_ROWS = 4096


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------
def init_embedding_tables(gen: torch.Generator, vocab_sizes: Sequence[int],
                          embed_dim: int, *, dtype=torch.float32,
                          device=None) -> List[torch.Tensor]:
    """One ``(vocab, embed_dim)`` table a field, N(0, 1/embed_dim)."""
    return [embed_init(gen, (v, embed_dim), scale=1.0 / embed_dim**0.5,
                       dtype=dtype, device=device) for v in vocab_sizes]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, weights=None,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag as a gather and a reduce: ids ``(B, hot)`` → ``(B, D)``
    (fixed-hotness bags; ``weights`` ``(B, hot)`` scale each row).

    The gather is ``index_select``, whose backward scatter-adds the rows'
    cotangents (``index_add_``): in a fixed order on the CPU, with atomics
    on a CUDA device, so two backward runs on the card may differ in their
    last bits. The clickstream's Zipf ids repeat up to 33,315 times in a
    field of train_batch's 65,536 rows, and advanced indexing's backward,
    which sorts and sums each id's run in one thread, took 163 ms for
    DLRM-RM2's 26 tables against 7.4 on an H100 SXM at 700 W
    (``probes/embedding_backward.py``)."""
    emb = torch.index_select(table, 0, ids.reshape(-1).long()).reshape(
        *ids.shape, table.shape[1])  # (B, hot, D)
    if weights is not None:
        emb = emb * weights[..., None]
    if mode == "sum":
        return emb.sum(dim=1)
    if mode == "mean":
        return emb.mean(dim=1)
    raise ValueError(mode)


def lookup_all_fields(tables: List[torch.Tensor], sparse_ids: torch.Tensor,
                      weights=None) -> torch.Tensor:
    """sparse_ids ``(B, n_fields, hot)`` → ``(B, n_fields, D)``."""
    return torch.stack([
        embedding_bag(t, sparse_ids[:, f],
                      None if weights is None else weights[:, f])
        for f, t in enumerate(tables)], dim=1)


# ---------------------------------------------------------------------------
# DCN-v2
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DCNv2Config:
    n_dense: int = 13
    vocab_sizes: Tuple[int, ...] = ()
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp_sizes: Tuple[int, ...] = (1024, 1024, 512)
    hot: int = 1
    dtype: str = "float32"

    @property
    def d_input(self) -> int:
        return self.n_dense + len(self.vocab_sizes) * self.embed_dim

    def param_count(self) -> int:
        d = self.d_input
        cross = self.n_cross_layers * (d * d + d)
        sizes = (d,) + self.mlp_sizes
        deep = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
        emb = sum(self.vocab_sizes) * self.embed_dim
        head = (d + self.mlp_sizes[-1]) + 1
        return cross + deep + emb + head


def init_dcn_v2(cfg: DCNv2Config, *, seed: int = 0, device=None):
    """Random DCN-v2 parameters from ``seed``, drawn on ``device`` (``cuda``
    unless given; raises without CUDA) by a generator of that device: the
    same seed gives the same weights on the same kind of device."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=getattr(torch, cfg.dtype), device=device)
    d = cfg.d_input
    return {
        "tables": init_embedding_tables(gen, cfg.vocab_sizes, cfg.embed_dim,
                                        **kw),
        "cross_w": [dense_init(gen, (d, d), **kw)
                    for _ in range(cfg.n_cross_layers)],
        "cross_b": [torch.zeros(d, **kw) for _ in range(cfg.n_cross_layers)],
        "deep": init_mlp(gen, (d,) + cfg.mlp_sizes, **kw),
        "head_w": dense_init(gen, (d + cfg.mlp_sizes[-1], 1), **kw),
        "head_b": torch.zeros(1, **kw),
    }


def dcn_v2_forward(params, cfg: DCNv2Config, dense, sparse_ids):
    """dense ``(B, n_dense)``, sparse_ids ``(B, n_fields, hot)`` → logits
    ``(B,)``: the full-rank cross ``x0·(x W + b) + x`` ∥ the deep MLP."""
    emb = lookup_all_fields(params["tables"], sparse_ids)  # (B, F, D)
    x0 = torch.cat([dense, emb.reshape(emb.shape[0], -1)], dim=-1)
    x = x0
    for w, b in zip(params["cross_w"], params["cross_b"]):
        x = x0 * (x @ w + b) + x
    deep = mlp_apply(params["deep"], x0)
    out = torch.cat([x, deep], dim=-1)
    return (out @ params["head_w"] + params["head_b"])[:, 0]


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    vocab_sizes: Tuple[int, ...] = ()
    embed_dim: int = 64
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    hot: int = 1
    dtype: str = "float32"

    def param_count(self) -> int:
        nf = len(self.vocab_sizes) + 1
        d_int = nf * (nf - 1) // 2 + self.embed_dim
        bot = (self.n_dense,) + self.bot_mlp
        top = (d_int,) + self.top_mlp
        return (
            sum(a * b + b for a, b in zip(bot[:-1], bot[1:]))
            + sum(a * b + b for a, b in zip(top[:-1], top[1:]))
            + sum(self.vocab_sizes) * self.embed_dim
        )


def init_dlrm(cfg: DLRMConfig, *, seed: int = 0, device=None):
    """Random DLRM parameters from ``seed`` on ``device`` (as
    :func:`init_dcn_v2`)."""
    if cfg.bot_mlp[-1] != cfg.embed_dim:
        raise ValueError("the bottom MLP must end at embed_dim")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=getattr(torch, cfg.dtype), device=device)
    nf = len(cfg.vocab_sizes) + 1
    d_int = nf * (nf - 1) // 2 + cfg.embed_dim
    return {
        "tables": init_embedding_tables(gen, cfg.vocab_sizes, cfg.embed_dim,
                                        **kw),
        "bot": init_mlp(gen, (cfg.n_dense,) + cfg.bot_mlp, **kw),
        "top": init_mlp(gen, (d_int,) + cfg.top_mlp, **kw),
    }


def dlrm_forward(params, cfg: DLRMConfig, dense, sparse_ids):
    """The pairwise dots of the dense feature and the fields' embeddings
    (the upper triangle, row-major as ``jnp.triu_indices``) ∥ the dense
    feature, through the top MLP → logits ``(B,)``."""
    dense_out = mlp_apply(params["bot"], dense)  # (B, D)
    emb = lookup_all_fields(params["tables"], sparse_ids)  # (B, F, D)
    feats = torch.cat([dense_out[:, None, :], emb], dim=1)  # (B, F+1, D)
    inter = torch.bmm(feats, feats.transpose(1, 2))
    nf = feats.shape[1]
    iu, ju = torch.triu_indices(nf, nf, 1, device=feats.device)
    pairs = inter[:, iu, ju]  # (B, nf (nf - 1) / 2)
    x = torch.cat([pairs, dense_out], dim=-1)
    return mlp_apply(params["top"], x)[:, 0]


# ---------------------------------------------------------------------------
# xDeepFM
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    vocab_sizes: Tuple[int, ...] = ()
    embed_dim: int = 10
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp_sizes: Tuple[int, ...] = (400, 400)
    hot: int = 1
    dtype: str = "float32"

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    def param_count(self) -> int:
        m = self.n_fields
        cin, h_prev = 0, m
        for h in self.cin_layers:
            cin += h * h_prev * m
            h_prev = h
        d_in = m * self.embed_dim
        sizes = (d_in,) + self.mlp_sizes + (1,)
        dnn = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
        emb = sum(self.vocab_sizes) * self.embed_dim
        linear = sum(self.vocab_sizes)
        return cin + dnn + emb + linear + sum(self.cin_layers)


def init_xdeepfm(cfg: XDeepFMConfig, *, seed: int = 0, device=None):
    """Random xDeepFM parameters from ``seed`` on ``device`` (as
    :func:`init_dcn_v2`). ``cin_w[i]`` is ``(H_i, H_{i-1}, m)`` and takes
    its fan-in from its first axis, as the reference's ``dense_init``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=getattr(torch, cfg.dtype), device=device)
    m = cfg.n_fields
    cin_w, h_prev = [], m
    for h in cfg.cin_layers:
        cin_w.append(dense_init(gen, (h, h_prev, m), **kw))
        h_prev = h
    return {
        "tables": init_embedding_tables(gen, cfg.vocab_sizes, cfg.embed_dim,
                                        **kw),
        "linear": [embed_init(gen, (v, 1), **kw) for v in cfg.vocab_sizes],
        "cin_w": cin_w,
        "cin_head": dense_init(gen, (sum(cfg.cin_layers), 1), **kw),
        "dnn": init_mlp(gen, (m * cfg.embed_dim,) + cfg.mlp_sizes + (1,),
                        **kw),
        "bias": torch.zeros(1, **kw),
    }


def _cin_block(x0, *cin_w):
    """The CIN of rows ``x0`` ``(b, m, D)`` → the sum-pooled feature maps
    ``(b, ΣH)``. Each layer is the reference's ``bhd,bmd->bhmd`` then
    ``bhmd,nhm->bnd``, with the maps held ``(b, D, H)`` and the outer
    product laid out ``(b, D, H, m)``, so the compression is one matmul
    over ``H·m``."""
    b, m, d = x0.shape
    x0_t = x0.transpose(1, 2).contiguous()  # (b, D, m)
    xk_t, pooled = x0_t, []
    for w in cin_w:
        n, h = w.shape[0], xk_t.shape[2]
        z = xk_t[:, :, :, None] * x0_t[:, :, None, :]  # (b, D, H, m)
        xk_t = (z.reshape(b * d, h * m) @ w.reshape(n, h * m).T
                ).reshape(b, d, n)
        pooled.append(xk_t.sum(dim=1))  # sum-pool over D → (b, n)
    return torch.cat(pooled, dim=-1)


def cin(cin_w: List[torch.Tensor], x0: torch.Tensor,
        rows: int = CIN_ROWS) -> torch.Tensor:
    """:func:`_cin_block` over blocks of ``rows`` rows (rows are
    independent, so each row's value is the whole batch's); under
    autograd each block is recomputed in the backward
    (``torch.utils.checkpoint``) rather than kept."""
    grad = torch.is_grad_enabled()
    return torch.cat([
        checkpoint(_cin_block, blk, *cin_w, use_reentrant=False) if grad
        else _cin_block(blk, *cin_w)
        for blk in x0.split(rows)])


def xdeepfm_forward(params, cfg: XDeepFMConfig, dense, sparse_ids):
    """CIN ∥ DNN ∥ linear → logits ``(B,)``. ``dense`` is unused (Criteo's
    numeric features are bucketized into the sparse fields, as in the
    paper's preprocessing)."""
    x0 = lookup_all_fields(params["tables"], sparse_ids)  # (B, m, D)
    cin_out = cin(params["cin_w"], x0) @ params["cin_head"]
    dnn_out = mlp_apply(params["dnn"], x0.reshape(x0.shape[0], -1))
    lin = sum(embedding_bag(t, sparse_ids[:, f])
              for f, t in enumerate(params["linear"]))
    return (cin_out + dnn_out + lin + params["bias"])[:, 0]


# ---------------------------------------------------------------------------
# Shared loss / serving helpers
# ---------------------------------------------------------------------------
def bce_logits_loss(logits, labels, valid: Optional[torch.Tensor] = None):
    """Binary cross-entropy on click logits, the reference's formula:
    ``max(l, 0) − l·y + log1p(exp(−|l|))``, the mean over the rows (over
    the ``valid`` ones when given)."""
    per = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    if valid is not None:
        w = valid.to(per.dtype)
        return (per * w).sum() / torch.clamp(w.sum(), min=1.0)
    return per.mean()


def retrieval_scores(forward_fn: Callable, params, cfg, dense_user,
                     sparse_user, candidate_ids, item_field: int = 0,
                     chunk: int = 65536) -> torch.Tensor:
    """Score ``candidate_ids`` ``(N,)`` for one user (``dense_user`` ``(1,
    n_dense)``, ``sparse_user`` ``(1, n_fields, hot)``): the user's row
    with the candidate in ``item_field``, through the model ``chunk``
    candidates at a time → ``(N,)`` logits."""
    out = []
    for c_ids in candidate_ids.split(chunk):
        b = c_ids.shape[0]
        dense = dense_user.expand(b, *dense_user.shape[1:])
        sparse = sparse_user.expand(b, *sparse_user.shape[1:]).clone()
        sparse[:, item_field, 0] = c_ids.to(sparse.dtype)
        out.append(forward_fn(params, cfg, dense, sparse))
    return torch.cat(out)
