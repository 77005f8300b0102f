"""The loss registry: SCE and the losses the paper compares it against
(§2.2, §4.1.3). Port of ``repro/core/losses.py``.

All losses share one signature so the trainer and benchmarks can swap
them freely::

    loss, aux = fn(x, y, targets, valid_mask=None, generator=None)

with ``x: (N, d)`` model outputs, ``y: (C, d)`` catalog embeddings,
``targets: (N,)`` positive class ids, ``valid_mask: (N,) bool`` and
``generator`` the ``torch.Generator`` of the sampled losses' draws (the
reference's ``key``).

* ``ce`` — full cross-entropy over the catalog (paper eq. 1).
* ``ce_chunked`` — the same CE with an online logsumexp over catalog
  chunks (``N × chunk`` logits at a time; ``logit_softcap`` caps every
  logit).
* ``ce_fused`` — CE through ``kernels.ops.fused_ce_loss`` (on the card
  the streamed ``fused_lse`` kernels, forward and backward).
* ``ce_fused_linear`` — CE through ``kernels.ops.linear_ce_loss`` (loss,
  dX and dW streamed, the positive plucked in the sweep, softcap-aware).
* ``bce`` / ``bce_plus`` — binary CE with 1 / k uniform negatives
  (eqs. 2, 3); ``gbce`` — gSASRec's calibrated BCE.
* ``ce_minus`` — sampled CE over k uniform negatives (eq. 4);
  ``ce_inbatch`` — the other positions' positives as negatives;
  ``ce_pop`` — popularity-proportional negatives.
* ``rece`` — Reduced Cross-Entropy (angular-LSH chunks).
* ``sce`` — the paper's contribution (``core/sce.py``).

Every random draw comes from ``generator`` through one private helper
(:func:`_sample_negatives`, :func:`_popularity_uniforms`,
:func:`_rece_planes`), so a test can hand the reference's draw to the
same arithmetic. The kernel-backed losses (``ce_chunked``, ``ce_fused``,
``ce_fused_linear``) attach the kernel guard's numerics sentinels as
``aux["sentinels"]`` (:func:`_sentinel_aux`), as the reference does.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import take_rows
from repro_torch.core.sce import (
    NEG_INF,
    SCEConfig,
    apply_softcap,
    sce_loss,
    sce_peak_elements,
)
from repro_torch.kernels import ops as _kops

Aux = Dict[str, torch.Tensor]
LossFn = Callable[..., Tuple[torch.Tensor, Aux]]


def _mean_over_valid(per_pos, valid_mask):
    if valid_mask is None:
        return per_pos.mean()
    w = valid_mask.to(per_pos.dtype)
    return (per_pos * w).sum() / torch.clamp(w.sum(), min=1.0)


def _sentinel_aux(kernel: str, per_pos, lse=None) -> Aux:
    """Per-position numerics sentinels for a kernel-backed loss
    (``kernels/guard/sentinels.py``), as ``aux["sentinels"]``, so the
    train step can report WHICH kernel went non-finite. Empty under guard
    policy ``off``."""
    from repro_torch.kernels import guard

    if guard.policy() == "off":
        return {}
    return {"sentinels": guard.loss_sentinels(kernel, per_pos, lse)}


def _need(generator, name):
    if generator is None:
        raise ValueError(f"{name} draws negatives: pass a torch.Generator")


def ce(x, y, targets, valid_mask=None, generator=None):
    """Full CE — materialises the (N, C) logit tensor (the memory hog)."""
    logits = x @ y.T  # (N, C)
    lse = torch.logsumexp(logits, dim=-1)
    pos = logits.gather(1, targets.long()[:, None])[:, 0]
    return _mean_over_valid(lse - pos, valid_mask), {"lse": lse.mean()}


def ce_chunked(x, y, targets, valid_mask=None, generator=None, *,
               chunk_size: int = 8192, logit_softcap: Optional[float] = None):
    """CE with an online logsumexp over catalog chunks: the same loss as
    :func:`ce`, ``N × chunk_size`` logits at a time. ``logit_softcap``
    caps every logit (positive and negatives) inside the sweep. Logits and
    the carry are f32."""
    f32 = torch.float32
    n, d = x.shape
    c = y.shape[0]
    x32 = x.to(f32)
    m = torch.full((n,), NEG_INF, dtype=f32, device=x.device)
    s = torch.zeros((n,), dtype=f32, device=x.device)
    for lo in range(0, c, chunk_size):
        y_c = y[lo:lo + chunk_size].to(f32)
        if y_c.shape[0] < chunk_size:  # zero rows, masked to -inf below
            y_c = torch.cat([y_c, y_c.new_zeros(chunk_size - y_c.shape[0],
                                                d)])
        logits = apply_softcap(x32 @ y_c.T, logit_softcap)
        ids = torch.arange(lo, lo + chunk_size, device=x.device)
        logits = torch.where((ids < c)[None, :], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(-1)
        m = m_new
    lse = m + torch.log(s)
    pos = apply_softcap(
        torch.einsum("nd,nd->n", x32, take_rows(y, targets).to(f32)),
        logit_softcap)
    per_pos = lse - pos
    aux: Aux = {"lse": lse.mean()}
    aux.update(_sentinel_aux("ce_chunked", per_pos, lse))
    return _mean_over_valid(per_pos, valid_mask), aux


def ce_fused(x, y, targets, valid_mask=None, generator=None):
    """CE through the streamed ``fused_lse`` kernels (``kernels/fused_ce``)."""
    per_pos = _kops.fused_ce_loss(x, y, targets)
    return _mean_over_valid(per_pos, valid_mask), _sentinel_aux(
        "fused_ce", per_pos)


def ce_fused_linear(x, y, targets, valid_mask=None, generator=None, *,
                    logit_softcap: Optional[float] = None,
                    block_n: int = 256, block_c: int = 512):
    """Full CE through the fused linear kernels (``kernels/linear_sce``):
    loss, dX and dW stream over catalog tiles, so the ``(N, C)`` logits
    never exist. ``logit_softcap`` applies inside the tile. ``block_c``
    is the plain version's catalog chunk; ``block_n`` (the reference's
    row tile) only sizes :func:`loss_peak_elements`: the CUDA kernel plans
    its own tiles."""
    del block_n
    per_pos = _kops.linear_ce_loss(x, y, targets, logit_softcap=logit_softcap,
                                   block_c=block_c)
    return _mean_over_valid(per_pos, valid_mask), _sentinel_aux(
        "linear_sce", per_pos)


def _sample_negatives(generator, n, k, catalog, device):
    """k uniform negatives per position — (n, k) int32."""
    return torch.randint(0, catalog, (n, k), generator=generator,
                         device=device, dtype=torch.int32)


def _neg_logits(x, y, neg_ids, targets):
    """Gathered negative logits with accidental-positive collisions masked."""
    neg_emb = take_rows(y, neg_ids)  # (N, k, d) — the BCE+ memory term
    logits = torch.einsum("nd,nkd->nk", x, neg_emb)
    collide = neg_ids == targets[:, None]
    return torch.where(collide, NEG_INF, logits)


def _pos_logits(x, y, targets):
    return torch.einsum("nd,nd->n", x, take_rows(y, targets))


def bce_plus(x, y, targets, valid_mask=None, generator=None, *,
             num_negatives: int = 1):
    """BCE with ``num_negatives`` uniform negatives (paper eq. 3)."""
    _need(generator, "bce_plus")
    neg_ids = _sample_negatives(generator, x.shape[0], num_negatives,
                                y.shape[0], x.device)
    pos = _pos_logits(x, y, targets)
    neg = _neg_logits(x, y, neg_ids, targets)
    per_pos = -F.logsigmoid(pos) - F.logsigmoid(-neg).sum(-1)
    return _mean_over_valid(per_pos, valid_mask), {}


def bce(x, y, targets, valid_mask=None, generator=None):
    """Original SASRec BCE: one positive, one uniform negative (eq. 2)."""
    return bce_plus(x, y, targets, valid_mask, generator, num_negatives=1)


def gbce(x, y, targets, valid_mask=None, generator=None, *,
         num_negatives: int = 1, t: float = 0.75):
    """gSASRec's generalized BCE (Petrov & Macdonald, RecSys '23): the
    positive's log-sigmoid scaled by ``beta = alpha·(t·(1 − 1/alpha) +
    1/alpha)`` with the sampling rate ``alpha = k / (C − 1)``."""
    _need(generator, "gbce")
    c = y.shape[0]
    alpha = num_negatives / max(c - 1, 1)
    beta = alpha * (t * (1.0 - 1.0 / alpha) + 1.0 / alpha)
    neg_ids = _sample_negatives(generator, x.shape[0], num_negatives, c,
                                x.device)
    pos = _pos_logits(x, y, targets)
    neg = _neg_logits(x, y, neg_ids, targets)
    per_pos = -beta * F.logsigmoid(pos) - F.logsigmoid(-neg).sum(-1)
    return _mean_over_valid(per_pos, valid_mask), {
        "beta": torch.tensor(beta, device=x.device)}


def _sampled_ce(x, y, targets, neg_ids, valid_mask):
    pos = _pos_logits(x, y, targets)
    neg = _neg_logits(x, y, neg_ids, targets)
    all_logits = torch.cat([pos[:, None], neg], dim=-1)
    per_pos = torch.logsumexp(all_logits, dim=-1) - pos
    return _mean_over_valid(per_pos, valid_mask), {}


def ce_minus(x, y, targets, valid_mask=None, generator=None, *,
             num_negatives: int = 1):
    """Sampled CE over k uniform negatives + the positive (paper eq. 4)."""
    _need(generator, "ce_minus")
    neg_ids = _sample_negatives(generator, x.shape[0], num_negatives,
                                y.shape[0], x.device)
    return _sampled_ce(x, y, targets, neg_ids, valid_mask)


def ce_inbatch(x, y, targets, valid_mask=None, generator=None):
    """In-batch negatives (paper §2.2): each position's negatives are the
    other positions' positives; a position sharing this one's target is
    masked, and padded positions give no negatives."""
    logits = x @ take_rows(y, targets).T  # (N, N): x_i · y_{t_j}
    collide = targets[None, :] == targets[:, None]
    eye = torch.eye(logits.shape[0], dtype=torch.bool, device=x.device)
    neg = torch.where(collide & ~eye, NEG_INF, logits)
    if valid_mask is not None:
        neg = torch.where(valid_mask[None, :], neg, NEG_INF)
        neg = torch.where(eye, logits, neg)  # own positive on the diagonal
    per_pos = torch.logsumexp(neg, dim=-1) - torch.diagonal(logits)
    return _mean_over_valid(per_pos, valid_mask), {}


def _popularity_uniforms(generator, n, k, total, device):
    """(n, k) f32 uniforms in ``[0, total)`` — the inverse-CDF draw."""
    return torch.rand((n, k), generator=generator, device=device) * total


def _sample_popularity_negatives(generator, n, k, popularity):
    """k popularity-proportional negatives per position by inverse CDF
    (``searchsorted``): O(C) memory, never an ``(n, k, C)`` tensor."""
    w = torch.clamp(popularity.to(torch.float32), min=0.0)
    cdf = torch.cumsum(w, dim=0)
    u = _popularity_uniforms(generator, n, k, cdf[-1], popularity.device)
    return torch.searchsorted(cdf, u, right=True).to(torch.int32)


def ce_pop(x, y, targets, valid_mask=None, generator=None, *,
           num_negatives: int = 1, popularity=None):
    """Sampled CE with popularity-proportional negatives (paper §2.2);
    ``popularity`` (C,) holds unnormalised counts, uniform if None."""
    _need(generator, "ce_pop")
    n, c = x.shape[0], y.shape[0]
    if popularity is None:
        neg_ids = _sample_negatives(generator, n, num_negatives, c, x.device)
    else:
        neg_ids = _sample_popularity_negatives(generator, n, num_negatives,
                                               popularity)
    return _sampled_ce(x, y, targets, neg_ids, valid_mask)


def lsh_codes(v, planes):
    """Angular-LSH bucket codes: the sign pattern of ``v @ planes`` packed
    into one integer per row, bit ``h`` for hyperplane ``h``. The
    reference packs into uint32; PyTorch shifts uint32 on too few
    backends, so the codes are int64 holding the same values in
    ``[0, 2³²)``. More than 32 hyperplanes are rejected, as there."""
    n_hashes = planes.shape[-1]
    if n_hashes > 32:
        raise ValueError(f"lsh_codes packs into 32 bits — n_hashes must be "
                         f"<= 32, got {n_hashes}")
    bits = torch.arange(n_hashes, device=v.device, dtype=torch.int64)
    s = (v.detach() @ planes) > 0
    return (s.to(torch.int64) << bits).sum(-1)


def _rece_planes(generator, d, n_hashes, device):
    """(d, n_hashes) standard-normal hyperplanes of one RECE step."""
    return torch.randn((d, n_hashes), generator=generator, device=device)


def rece(x, y, targets, valid_mask=None, generator=None, *,
         n_hashes: int = 8, n_chunks: int = 16):
    """RECE — Reduced Cross-Entropy (Gusak et al., CIKM '24): angular-LSH
    codes sort all positions and all catalog items; equal chunks of each
    sorted order are aligned, and CE is taken within a chunk.

    The equal-chunk cut is lossy, as in the reference: a tail of
    ``N mod n_chunks`` positions adds nothing (the mean is over covered
    and valid positions, ``aux["covered_frac"]``), and a tail of
    ``C mod n_chunks`` items is nobody's negative this step
    (``aux["catalog_frac"]``)."""
    _need(generator, "rece")
    if not 1 <= n_hashes <= 32:
        raise ValueError(f"n_hashes must be in [1, 32], got {n_hashes}")
    n, d = x.shape
    c = y.shape[0]
    planes = _rece_planes(generator, d, n_hashes, x.device)

    x_order = torch.argsort(lsh_codes(x, planes), stable=True)
    y_order = torch.argsort(lsh_codes(y, planes), stable=True)
    cx, cy = n // n_chunks, c // n_chunks
    xi = x_order[: n_chunks * cx].reshape(n_chunks, cx)
    yi = y_order[: n_chunks * cy].reshape(n_chunks, cy)

    x_b = x[xi]  # (n_chunks, cx, d)
    y_b = y[yi]  # (n_chunks, cy, d)
    tgt_b = targets[xi]
    pos = torch.einsum("nxd,nxd->nx", x_b, take_rows(y, tgt_b))
    neg = torch.einsum("nxd,nyd->nxy", x_b, y_b)
    collide = yi[:, None, :] == tgt_b[:, :, None]
    neg = torch.where(collide, NEG_INF, neg)
    all_logits = torch.cat([pos[..., None], neg], dim=-1)
    losses = torch.logsumexp(all_logits, dim=-1) - pos  # (n_chunks, cx)

    flat = xi.reshape(-1)
    per_pos = torch.zeros((n,), dtype=losses.dtype, device=x.device).scatter(
        0, flat, losses.reshape(-1))
    covered = torch.zeros((n,), dtype=torch.bool, device=x.device)
    covered[flat] = True
    if valid_mask is not None:
        covered = covered & valid_mask
        n_valid = torch.clamp(valid_mask.to(per_pos.dtype).sum(), min=1.0)
    else:
        n_valid = torch.tensor(float(n), dtype=per_pos.dtype,
                               device=x.device)
    w = covered.to(per_pos.dtype)
    aux = {
        "covered_frac": w.sum() / n_valid,
        "catalog_frac": torch.tensor((n_chunks * cy) / max(c, 1),
                                     dtype=per_pos.dtype, device=x.device),
    }
    return (per_pos * w).sum() / torch.clamp(w.sum(), min=1.0), aux


def _sce_wrapper(x, y, targets, valid_mask=None, generator=None, *,
                 cfg: SCEConfig, omega=None):
    """SCE in the registry's signature; ``omega`` injects the Mix draw."""
    return sce_loss(x, y, targets, cfg=cfg, valid_mask=valid_mask,
                    generator=generator, omega=omega, return_aux=True)


_REGISTRY = {
    "ce": lambda **kw: ce,
    "ce_chunked": lambda **kw: functools.partial(ce_chunked, **kw),
    "ce_fused": lambda **kw: ce_fused,
    "ce_fused_linear": lambda **kw: functools.partial(ce_fused_linear, **kw),
    "bce": lambda **kw: bce,
    "bce_plus": lambda **kw: functools.partial(bce_plus, **kw),
    "gbce": lambda **kw: functools.partial(gbce, **kw),
    "ce_minus": lambda **kw: functools.partial(ce_minus, **kw),
    "ce_inbatch": lambda **kw: ce_inbatch,
    "ce_pop": lambda **kw: functools.partial(ce_pop, **kw),
    "rece": lambda **kw: functools.partial(rece, **kw),
    "sce": lambda **kw: functools.partial(_sce_wrapper, **kw),
}


def make_loss(name: str, **kwargs) -> LossFn:
    """Build a loss function by registry name. See the module docstring."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown loss {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def loss_peak_elements(
    name: str,
    n_positions: int,
    catalog: int,
    d: int,
    *,
    num_negatives: int = 0,
    chunk_size: int = 8192,
    n_chunks: int = 16,
    block_n: int = 256,
    block_c: int = 512,
    cfg: Optional[SCEConfig] = None,
    **_loss_kwargs,
) -> int:
    """Analytic peak element count of loss-side tensors (paper Figs. 2/5),
    the reference's model, copied: the logit tensor plus any materialised
    negative or candidate embedding gathers. Takes the kwargs
    :func:`make_loss` takes and ignores those that do not affect memory."""
    if name in ("ce",):
        return n_positions * catalog
    if name == "ce_chunked":
        return n_positions * min(chunk_size, catalog)
    if name == "ce_fused":
        # The reference's model: forward-only fusion whose autodiff
        # backward rematerialises the dense (N, C) logits.
        return n_positions * catalog
    if name == "ce_fused_linear":
        # 4 f32 vectors of length N plus one (block_n, block_c) tile.
        return 4 * n_positions + min(block_n, n_positions) * min(
            block_c, catalog
        )
    if name in ("bce", "bce_plus", "gbce", "ce_minus", "ce_pop"):
        k = max(1, num_negatives)
        return n_positions * k + n_positions * k * d
    if name == "ce_inbatch":
        return n_positions * n_positions + n_positions * d
    if name == "rece":
        # n_chunks aligned (N/k) × (C/k) chunks (+1 column for the
        # positive), the gathered y_b and its cotangent, x_b and pos_emb.
        k = max(1, n_chunks)
        cx, cy = n_positions // k, catalog // k
        chunk_logits = k * cx * (cy + 1)
        cand = 2 * k * cy * d
        x_gather = 2 * k * cx * d
        return chunk_logits + cand + x_gather
    if name == "sce":
        assert cfg is not None
        return sce_peak_elements(
            cfg, n_positions, catalog, d, fused=cfg.use_kernel
        )["total"] + cfg.n_buckets * cfg.bucket_size_x * d  # x_b gather
    raise KeyError(name)
