"""Collectives over a mesh axis, with the autograd rules the distributed
SCE loss needs, and the vocab-parallel stack's exchanges (port of
``repro/dist/collectives.py``: ``all_to_all_bucket_shuffle``,
``distributed_topk``, ``distributed_topk_from_local``,
``distributed_lse_from_local`` and the payload log).

``torch.distributed`` collectives carry no autograd rule, so each one the
loss differentiates through is an ``autograd.Function`` that says how
its gradient crosses the axis. A value on one rank of an axis is either
*replicated* along it (every rank of the line holds the same value, and
computes the same thing from it) or a *part* (each rank holds its own).
The gradient a rank holds for a replicated value is the whole gradient;
for a part, the gradient of that part. Then, as JAX's ``shard_map``
transposes its collectives:

* :func:`psum` — parts → their replicated sum; the gradient of each part
  is the sum's gradient as it is (no sum of cotangents: that would count
  the replicated computation after it once per rank);
* :func:`to_parts` — a replicated value used as each rank's own part
  (JAX's implicit ``pvary``); the identity forward, its gradient summed
  over the axis, so every rank's share reaches the value once;
* :func:`pmax` and :func:`all_gather` — on values without a gradient
  (the max shift of a logsumexp, candidate ids and selection scores);
* :func:`gather_rows` — parts → their concatenation, replicated; the
  gradient of each part is its block of the cotangents summed over the
  axis (JAX's transpose of ``all_gather``);
* :func:`all_to_all_bucket_shuffle` — a permutation of blocks across the
  axis, whose gradient is the inverse all-to-all.

The top-k and LSE merges come in two layers: :func:`merge_gathered_topk`
and :func:`merge_gathered_lse` merge lists already stacked in shard order
(plain functions, which a caller holding every shard's result — one card
running each shard's stage in turn — calls itself), and the collectives
:func:`distributed_topk_from_local` / :func:`distributed_lse_from_local`
gather over the axis first.

An :class:`~repro_torch.dist.sharding.Axis` of size 1 has no group: each
collective is then the identity on this rank's value, as a JAX collective
over a size-1 axis is.

Payload accounting
------------------
:func:`all_to_all_bucket_shuffle`, :func:`distributed_topk_from_local`
and :func:`distributed_lse_from_local` record their modelled per-rank
wire bytes, with the reference's op names and shapes, in a log (:func:`reset_payload_log`, :func:`payload_log`,
:func:`payload_summary`). In the reference the log models the traced
program text; here it records every call.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.sce import _dense_topk_ids
from repro_torch.dist.sharding import Axis

_PAYLOAD_LOG: List[Dict[str, Any]] = []


def reset_payload_log() -> None:
    """Clear the collective payload log."""
    _PAYLOAD_LOG.clear()


def payload_log() -> List[Dict[str, Any]]:
    """Records appended since the last reset (most recent last)."""
    return list(_PAYLOAD_LOG)


def payload_summary() -> Dict[str, Any]:
    """Aggregate of the log: total and per-op wire bytes, and counts."""
    per_op: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for rec in _PAYLOAD_LOG:
        per_op[rec["op"]] = per_op.get(rec["op"], 0.0) + rec["wire_bytes"]
        counts[rec["op"]] = counts.get(rec["op"], 0) + 1
    return {
        "total_bytes": sum(per_op.values()),
        "per_op_bytes": per_op,
        "counts": counts,
    }


def _record(op: str, axis_name: str, shape, dtype: torch.dtype,
            group: int) -> None:
    size = math.prod(shape) * dtype.itemsize
    # ring model: S·(g-1)/g over the wire
    wire = size * (group - 1) / max(group, 1)
    _PAYLOAD_LOG.append(
        {
            "op": op,
            "axis": axis_name,
            "shape": tuple(shape),
            "dtype": str(dtype).removeprefix("torch."),
            "payload_bytes": size,
            "wire_bytes": wire,
            "group_size": group,
        }
    )


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ToParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def psum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum of the parts ``t`` over ``axis``, replicated on every rank of
    the line; differentiable, the gradient of each part being the sum's
    gradient (module docstring)."""
    if axis.group is None:
        return t
    return _PSum.apply(t, axis.group)


def to_parts(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``t``, replicated over ``axis``, as each rank's own part: the
    identity, whose gradient is summed over the axis."""
    if axis.group is None:
        return t
    return _ToParts.apply(t, axis.group)


def pmax(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise max over ``axis`` of a value without a gradient."""
    t = t.detach()
    if axis.group is None:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out


def all_gather(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``(m,) + t.shape``: every rank's ``t`` in axis order, without a
    gradient."""
    t = t.detach().contiguous()
    if axis.group is None:
        return t[None]
    out = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(out, t, group=axis.group)
    return torch.stack(out)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return all_gather(t, axis).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        # every rank's cotangent of the whole, summed; this rank's block
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.axis.group)
        return g.chunk(ctx.axis.size)[ctx.axis.index], None


def gather_rows(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in axis order,
    replicated; differentiable: the gradient of this rank's ``t`` is its
    block of the whole's gradient summed over the axis."""
    if axis.group is None:
        return t
    return _GatherRows.apply(t.contiguous(), axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, group):
        ctx.group = group
        out = torch.empty_like(xs)
        dist.all_to_all_single(out, xs.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def all_to_all_bucket_shuffle(x: torch.Tensor,
                              axis: Optional[Axis]) -> torch.Tensor:
    """Route per-bucket payloads to their owning shard: shard ``j`` owns
    buckets ``[j·n_b/m, (j+1)·n_b/m)``; 1/m the payload of an all-gather.

    ``x`` (n_b, ...) is this shard's payload for all ``n_b`` buckets
    (``m`` must divide ``n_b``). → ``(m, n_b/m, ...)``: ``out[i]`` is
    shard ``i``'s payload for this shard's buckets. Differentiable: the
    gradient is the inverse all-to-all, so a payload's gradient returns
    to the shard it came from. With ``axis`` None (the reference's call
    outside ``shard_map``): ``x`` reshaped to ``(1, n_b, ...)``.
    """
    if axis is None:
        return x.reshape((1,) + tuple(x.shape))
    m, n_b = axis.size, x.shape[0]
    if n_b % m:
        raise ValueError(f"{n_b} buckets do not divide over {m} shards")
    xs = x.reshape((m, n_b // m) + tuple(x.shape[1:]))
    _record("all-to-all", axis.name, tuple(xs.shape), x.dtype, m)
    if axis.group is None:
        return xs
    return _AllToAll.apply(xs, axis.group)


def merge_gathered_topk(vals_g: torch.Tensor, gids_g: torch.Tensor, k: int,
                        *, ties: str = "position"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-``min(k, m·k_local)`` of ``m`` stacked candidate lists
    ``(m, ..., k_local)`` (shard order; each sorted descending, ties in
    ascending id) → ``(values, ids)``.

    ``ties="position"``: value ties go to the earlier position in the
    union (shard order, then list order) — the lower global id when shard
    ``i`` owns only ids below shard ``i+1``'s, the dense rule
    (``lax.top_k``'s). ``ties="id"``: ties go to the lower id whatever
    the shard, for ids interleaved across shards (candidate positions of
    the retrieval step).
    """
    if ties not in ("position", "id"):
        raise ValueError(f"ties {ties!r}")
    m, k_local = vals_g.shape[0], vals_g.shape[-1]
    union_shape = tuple(vals_g.shape[1:-1]) + (m * k_local,)
    vals_u = vals_g.movedim(0, -2).reshape(union_shape)
    gids_u = gids_g.movedim(0, -2).reshape(union_shape)
    if ties == "id":
        order = torch.sort(gids_u, dim=-1, stable=True).indices
        vals_u, gids_u = vals_u.gather(-1, order), gids_u.gather(-1, order)
    sel = _dense_topk_ids(vals_u, min(k, m * k_local)).long()
    return vals_u.gather(-1, sel), gids_u.gather(-1, sel)


def merge_gathered_lse(m_g: torch.Tensor, s_g: torch.Tensor) -> torch.Tensor:
    """The global ``logsumexp`` of ``m`` stacked online-LSE carries
    ``(m, ...)``: ``M + log(Σ s · exp(m − M))``, ``M`` their max — the
    arithmetic :func:`distributed_lse_from_local` runs over the axis."""
    top = m_g.amax(dim=0)
    return top + torch.log((s_g * torch.exp(m_g - top)).sum(dim=0))


def distributed_topk_from_local(
    vals_l: torch.Tensor,
    gids_l: torch.Tensor,
    k: int,
    axis: Optional[Axis],
    *,
    ties: str = "position",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top candidates into the exact global top-``k``.

    ``vals_l`` (..., k_local) are this shard's candidates sorted
    descending with ties in ascending-global-id order (as ``mips_topk``
    and a stable sort give them), ``gids_l`` their GLOBAL ids. The
    candidates of every shard are gathered in shard order and merged by
    :func:`merge_gathered_topk` (``ties``: its tie rule; by default the
    earlier position, the lower global id provided shard ``i`` owns only
    ids below shard ``i+1``'s). → ``(values, global_ids)``, replicated
    over the axis. With ``axis`` None (the reference's call outside
    ``shard_map``): the top-``k`` of the given candidates as they are.
    """
    k_local = vals_l.shape[-1]
    if axis is None:
        sel = _dense_topk_ids(vals_l, min(k, k_local)).long()
        return vals_l.gather(-1, sel), gids_l.gather(-1, sel)
    m = axis.size
    _record("all-gather", axis.name, (m,) + tuple(vals_l.shape),
            vals_l.dtype, m)
    _record("all-gather", axis.name, (m,) + tuple(gids_l.shape),
            gids_l.dtype, m)
    return merge_gathered_topk(all_gather(vals_l, axis),
                               all_gather(gids_l, axis), k, ties=ties)


def distributed_topk(scores: torch.Tensor, k: int, axis: Optional[Axis]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact global top-``k`` over the last, axis-sharded dim.

    ``scores`` (..., C_local) is this shard's slice of a score matrix
    whose global column ``c`` lives on shard ``c // C_local``. Two
    stages: the local top-``min(k, C_local)``, then
    :func:`distributed_topk_from_local` over the axis; ties go to the
    lower global id, as one device's top-k on the concatenated scores.
    → ``(values, global_ids int32, source_shard)``, replicated. With
    ``axis`` None: the top-``min(k, C_local)`` with zero source shards.
    """
    c_local = scores.shape[-1]
    k_local = min(k, c_local)
    idx = _dense_topk_ids(scores, k_local)
    vals = scores.gather(-1, idx.long())
    if axis is None:
        return vals, idx, torch.zeros_like(idx)
    gids = idx + axis.index * c_local
    vals, gids = distributed_topk_from_local(vals, gids, k, axis)
    return vals, gids, gids // c_local


def distributed_lse_from_local(m_l: torch.Tensor, s_l: torch.Tensor,
                               axis: Optional[Axis]) -> torch.Tensor:
    """Merge per-shard online-logsumexp carries ``(m, s)`` into the
    global ``logsumexp``, replicated over the axis:
    ``M = pmax(m_l); M + log(psum(s_l · exp(m_l − M)))``. Every ``exp``
    argument is ≤ 0, so a shard with an empty slice (``m_l = NEG_INF``)
    folds in as an exact zero. With ``axis`` None: ``m_l + log(s_l)``."""
    if axis is None:
        return m_l + torch.log(s_l)
    _record("all-reduce", axis.name, tuple(m_l.shape), m_l.dtype, axis.size)
    _record("all-reduce", axis.name, tuple(s_l.shape), s_l.dtype, axis.size)
    m_g = pmax(m_l, axis)
    s_g = psum(s_l * torch.exp(m_l - m_g), axis)
    return m_g + torch.log(s_g)
