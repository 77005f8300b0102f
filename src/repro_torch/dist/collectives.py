"""Collectives over a mesh axis, with the autograd rules the distributed
SCE loss needs (port of ``distributed_topk_from_local``,
``distributed_lse_from_local`` and the payload log of
``repro/dist/collectives.py``).

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
  (the max shift of a logsumexp, candidate ids and selection scores).

An :class:`~repro_torch.dist.sharding.Axis` of size 1 has no group: each
collective is then the identity on this rank's value, as a JAX collective
over a size-1 axis is.

Payload accounting
------------------
:func:`distributed_topk_from_local` and :func:`distributed_lse_from_local`
record their modelled per-rank wire bytes, with the reference's op names
and shapes, in a log (:func:`reset_payload_log`, :func:`payload_log`,
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


def distributed_topk_from_local(
    vals_l: torch.Tensor,
    gids_l: torch.Tensor,
    k: int,
    axis: Optional[Axis],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top candidates into the exact global top-``k``.

    ``vals_l`` (..., k_local) are this shard's candidates sorted
    descending with ties in ascending-global-id order (as ``mips_topk``
    and a stable sort give them), ``gids_l`` their GLOBAL ids. The
    candidates of every shard are gathered in shard order and the top
    ``min(k, m·k_local)`` kept, ties to the earlier position — the lower
    global id, the dense tie rule, provided shard ``i`` owns only ids
    below shard ``i+1``'s. → ``(values, global_ids)``, replicated over
    the axis. With ``axis`` None (the reference's call outside
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
    vals_g = all_gather(vals_l, axis)  # (m, ..., k_local)
    gids_g = all_gather(gids_l, axis)
    union_shape = tuple(vals_l.shape[:-1]) + (m * k_local,)
    vals_u = vals_g.movedim(0, -2).reshape(union_shape)
    gids_u = gids_g.movedim(0, -2).reshape(union_shape)
    # ties to the earlier position, the lower global id (lax.top_k's rule)
    sel = _dense_topk_ids(vals_u, min(k, m * k_local)).long()
    return vals_u.gather(-1, sel), gids_u.gather(-1, sel)


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
