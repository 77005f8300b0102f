"""In-bucket SCE with the candidates gathered from the catalog, on the
H100 — the wrappers of ``csrc/sce_gather.cu`` (port of ``sce_gather_loss``
and ``sce_gather_plse`` of ``repro/kernels/sce_prefetch.py``).

The loss, one wrapper per kernel, each with its own launch counter:

* :func:`sce_gather_fwd` — per-(bucket, row) loss and logsumexp (f32
  FMAs);
* :func:`sce_gather_dx` — the gradient of ``x_b`` (n_b, b_x, d);
* :func:`sce_gather_dy` — the gradient of the whole catalog ``y`` (C, d),
  added into a zeroed buffer row by row (``atomicAdd``: not bitwise
  repeatable, rows no bucket selected stay exactly 0).

dX and dY recompute the logits and take both products on the tensor
cores in 3xTF32 (``csrc/tf32x3_tile.cuh``), which holds the f32
tolerance; their exp takes ``min(l − lse, 44)``, the one deviation from
the plain version (see the source). :func:`bwd_plan` is their launch plan
without a card, :func:`planned_smem` the guard's budget.

The partial logsumexp of the distributed merge (no positive, from
``(NEG_INF, 0)``), again with a counter per wrapper, apart from the
loss's:

* :func:`sce_gather_plse_fwd` — the forward kernel without the positive;
* :func:`sce_gather_plse_dx` / :func:`sce_gather_plse_dy` — the loss's
  dX and dY kernels with the plse in place of the lse (the reference's
  ``_plse_vjp_bwd`` calls the loss's ``_gbwd`` too).

:class:`SCEGatherLoss` and :class:`SCEGatherPLSE` tie them together for
autograd: the forward saves ``lse`` (or ``plse``), the backward launches
dX and dY; the loss's also computes the positive's cotangent
``d_pos = (exp(pos − lse) − 1)·g`` as a plain tensor expression, as the
reference's ``_loss_vjp_bwd`` does. The wrappers take CUDA tensors only;
the CPU paths are ``kernels/ref.py::sce_gather_loss_ref`` and
``sce_gather_plse_ref``, chosen by ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.linear_sce import MAX_SMEM, padded_depth

MAX_D = 256  # kMaxD in the source
STREAM_ROWS = 32  # kStreamRows: rows of a streamed backward tile
STAGES = 3  # kStages: the backward's raw ring


def fwd_smem(d: int) -> int:
    """The forward's dynamic shared memory (``fwd_smem`` in the source):
    64 rows of x_b and 64 candidate rows at a pitch of an odd number of
    float4s, and 2 × 64 row and candidate ids."""
    pitch = 4 * ((-(-d // 4)) | 1)
    return 4 * (64 + 64) * pitch + 4 * 2 * 64


def bwd_plan(d: int):
    """``(warps, smem bytes)`` of the dX and dY launches at depth d, a copy
    of ``bwd_plan`` in ``csrc/sce_gather.cu`` that needs no card
    (:func:`library_bwd_plan` reads the kernel's own; the CUDA tests and
    ``chip_smoke.py`` hold the two equal): 32 owned rows a warp, split into
    A fragments (four warps up to ``dp`` 128, two to 192, else one); the
    split 32-row streamed tile; three raw 32-row stages with their per-row
    inputs (lse, g and targets, or candidate ids); the two-slot ids
    ring."""
    dp = padded_depth(d)
    warps = 4 if dp <= 128 else (2 if dp <= 192 else 1)
    return warps, (8 * dp * (32 * warps + STREAM_ROWS)
                   + 4 * (dp + 3) * STREAM_ROWS * STAGES + 8 * STREAM_ROWS)


def library_bwd_plan(d: int):
    """``(warps, smem bytes)`` as the built library plans dX and dY
    (``sce_gather_bwd_plan``)."""
    warps = ctypes.c_int()
    smem = _lib().sce_gather_bwd_plan(d, ctypes.byref(warps))
    if smem < 0:
        raise ValueError(f"sce_gather_bwd_plan: d={d} outside (0, {MAX_D}]")
    return warps.value, smem


def planned_smem(d: int) -> int:
    """Dynamic shared memory per block of the largest launch at depth d:
    the forward's (:func:`fwd_smem`) or dX / dY's (:func:`bwd_plan`). The
    kernel guard checks it against the 227 KB a block may use."""
    return max(fwd_smem(d), bwd_plan(d)[1])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as ``c_void_p``, ints as ``c_int``, the cap as ``c_float``)."""
    lib = _build.load("sce_gather")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("sce_gather_fwd_launch", "sce_gather_dx_launch",
                 "sce_gather_dy_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 8 + [i] * 5 + [f, p]
        fn.restype = ctypes.c_int
    lib.sce_gather_plse_fwd_launch.argtypes = [p] * 6 + [i] * 5 + [f, p]
    lib.sce_gather_plse_fwd_launch.restype = ctypes.c_int
    lib.sce_gather_bwd_plan.argtypes = [i, p]
    lib.sce_gather_bwd_plan.restype = ctypes.c_int
    return lib


def _check(x_b, y, idx_y, tgt_b, cand_ids, *rows):
    """Device, type, shape and contiguity of one call; returns
    ``(n_b, b_x, b_y, C, d)``. ``rows`` are the (n_b, b_x) f32 inputs
    (``pos`` or ``lse`` and ``g``)."""
    tensors = (x_b, y, idx_y, tgt_b, cand_ids) + rows
    if not all(t.is_cuda for t in tensors):
        raise ValueError("sce_gather kernels take CUDA tensors only")
    if any(t.device != x_b.device for t in tensors):
        raise ValueError("sce_gather inputs lie on different devices")
    if any(t.dtype != torch.float32 for t in (x_b, y) + rows):
        raise TypeError("sce_gather takes float32 x_b, y, pos/lse and g")
    if any(t.dtype != torch.int32 for t in (idx_y, tgt_b, cand_ids)):
        raise TypeError("sce_gather takes int32 idx_y, tgt_b and cand_ids")
    if x_b.ndim != 3 or y.ndim != 2 or x_b.shape[2] != y.shape[1]:
        raise ValueError(f"need x_b (n_b, b_x, d), y (C, d); got "
                         f"{tuple(x_b.shape)}, {tuple(y.shape)}")
    n_b, b_x, d = x_b.shape
    if idx_y.ndim != 2 or idx_y.shape[0] != n_b or cand_ids.shape != idx_y.shape:
        raise ValueError(f"need idx_y and cand_ids (n_b, b_y); got "
                         f"{tuple(idx_y.shape)}, {tuple(cand_ids.shape)}")
    if any(t.shape != (n_b, b_x) for t in (tgt_b,) + rows):
        raise ValueError(f"tgt_b, pos/lse and g must be ({n_b}, {b_x})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sce_gather takes contiguous tensors")
    if not 0 < d <= MAX_D:
        raise ValueError(f"d={d} outside (0, {MAX_D}]")
    b_y, c = idx_y.shape[1], y.shape[0]
    if min(n_b, b_x, b_y, c) == 0:
        raise ValueError("sce_gather needs non-empty buckets and catalog")
    return n_b, b_x, b_y, c, d


def _cap(logit_softcap) -> float:
    if logit_softcap is None:
        return 0.0
    if not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    return float(logit_softcap)


def _launch(name, args, shape, device):
    n_b, b_x, b_y, c, d = shape
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_lib(), name)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args[:-1]],
            n_b, b_x, b_y, c, d, args[-1], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{name} failed: cudaError {err} (n_b={n_b}, b_x={b_x}, "
            f"b_y={b_y}, C={c}, d={d})"
        )


def sce_gather_fwd(x_b, y, idx_y, tgt_b, cand_ids, pos_logit, *,
                   logit_softcap=None):
    """Forward kernel: ``(loss, lse)``, each (n_b, b_x) f32. ``pos_logit``
    arrives already capped; ``logit_softcap`` caps the in-bucket logits
    before the mask. Matches ``ref.sce_gather_loss_ref``."""
    shape = _check(x_b, y, idx_y, tgt_b, cand_ids, pos_logit)
    loss = torch.empty_like(pos_logit)
    lse = torch.empty_like(pos_logit)
    _launch("sce_gather_fwd_launch",
            (x_b, y, idx_y, tgt_b, cand_ids, pos_logit, loss, lse,
             _cap(logit_softcap)), shape, x_b.device)
    sce_gather_fwd.launches += 1
    return loss, lse


def _dx(x_b, y, idx_y, tgt_b, cand_ids, lse, g, cap):
    shape = _check(x_b, y, idx_y, tgt_b, cand_ids, lse, g)
    dx = torch.empty_like(x_b)
    _launch("sce_gather_dx_launch",
            (x_b, y, idx_y, tgt_b, cand_ids, lse, g, dx, _cap(cap)), shape,
            x_b.device)
    return dx


def _dy(x_b, y, idx_y, tgt_b, cand_ids, lse, g, cap):
    shape = _check(x_b, y, idx_y, tgt_b, cand_ids, lse, g)
    dy = torch.zeros_like(y)
    _launch("sce_gather_dy_launch",
            (x_b, y, idx_y, tgt_b, cand_ids, lse, g, dy, _cap(cap)), shape,
            x_b.device)
    return dy


def sce_gather_dx(x_b, y, idx_y, tgt_b, cand_ids, lse, g, *,
                  logit_softcap=None):
    """dX kernel: the (n_b, b_x, d) gradient of ``x_b`` for the upstream
    cotangent ``g`` (n_b, b_x) of the loss."""
    dx = _dx(x_b, y, idx_y, tgt_b, cand_ids, lse, g, logit_softcap)
    sce_gather_dx.launches += 1
    return dx


def sce_gather_dy(x_b, y, idx_y, tgt_b, cand_ids, lse, g, *,
                  logit_softcap=None):
    """dY kernel: the (C, d) gradient of the catalog ``y``; each selected
    row ``idx_y[n, j]`` receives the sum over buckets, every other row is
    exactly 0. The sum order varies from run to run (atomics)."""
    dy = _dy(x_b, y, idx_y, tgt_b, cand_ids, lse, g, logit_softcap)
    sce_gather_dy.launches += 1
    return dy


def sce_gather_plse_fwd(x_b, y, idx_y, tgt_b, cand_ids, *,
                        logit_softcap=None):
    """Partial-LSE forward kernel: (n_b, b_x) f32 logsumexp over the
    unmasked candidates alone, from ``(NEG_INF, 0)``; a row with every
    candidate masked is ``NEG_INF`` (−1e30), never ``−inf``. Matches
    ``ref.sce_gather_plse_ref``."""
    shape = _check(x_b, y, idx_y, tgt_b, cand_ids)
    plse = torch.empty(x_b.shape[:2], dtype=torch.float32,
                       device=x_b.device)
    _launch("sce_gather_plse_fwd_launch",
            (x_b, y, idx_y, tgt_b, cand_ids, plse, _cap(logit_softcap)),
            shape, x_b.device)
    sce_gather_plse_fwd.launches += 1
    return plse


def sce_gather_plse_dx(x_b, y, idx_y, tgt_b, cand_ids, plse, g, *,
                       logit_softcap=None):
    """The dX kernel for the partial LSE: ``gw = exp(l − plse)·g``, 0
    where masked, so a row with no unmasked candidate gets exactly 0."""
    dx = _dx(x_b, y, idx_y, tgt_b, cand_ids, plse, g, logit_softcap)
    sce_gather_plse_dx.launches += 1
    return dx


def sce_gather_plse_dy(x_b, y, idx_y, tgt_b, cand_ids, plse, g, *,
                       logit_softcap=None):
    """The dY kernel for the partial LSE (atomics, as
    :func:`sce_gather_dy`)."""
    dy = _dy(x_b, y, idx_y, tgt_b, cand_ids, plse, g, logit_softcap)
    sce_gather_plse_dy.launches += 1
    return dy


for _fn in (sce_gather_fwd, sce_gather_dx, sce_gather_dy,
            sce_gather_plse_fwd, sce_gather_plse_dx, sce_gather_plse_dy):
    _fn.launches = 0


class SCEGatherLoss(torch.autograd.Function):
    """``loss (n_b, b_x)`` of ``(x_b, y, idx_y, tgt_b, cand_ids,
    pos_logit, logit_softcap)``; gradients for ``x_b``, ``y`` and
    ``pos_logit`` (the ids get none)."""

    @staticmethod
    def forward(ctx, x_b, y, idx_y, tgt_b, cand_ids, pos_logit,
                logit_softcap):
        loss, lse = sce_gather_fwd(x_b, y, idx_y, tgt_b, cand_ids, pos_logit,
                                   logit_softcap=logit_softcap)
        ctx.save_for_backward(x_b, y, idx_y, tgt_b, cand_ids, pos_logit, lse)
        ctx.logit_softcap = logit_softcap
        return loss

    @staticmethod
    def backward(ctx, g):
        x_b, y, idx_y, tgt_b, cand_ids, pos_logit, lse = ctx.saved_tensors
        g = g.contiguous()
        args = (x_b, y, idx_y, tgt_b, cand_ids, lse, g)
        cap = ctx.logit_softcap
        need = ctx.needs_input_grad
        dx = sce_gather_dx(*args, logit_softcap=cap) if need[0] else None
        dy = sce_gather_dy(*args, logit_softcap=cap) if need[1] else None
        d_pos = (torch.exp(pos_logit - lse) - 1.0) * g if need[5] else None
        return dx, dy, None, None, None, d_pos, None


def sce_gather_loss(x_b, y, idx_y, tgt_b, cand_ids, pos_logit, *,
                    logit_softcap=None):
    """In-bucket SCE losses (n_b, b_x) on the card, differentiable in
    ``x_b``, ``y`` and ``pos_logit``; the ``(n_b, b_y, d)`` candidate
    tensor never exists. See the module docstring."""
    return SCEGatherLoss.apply(x_b, y, idx_y, tgt_b, cand_ids, pos_logit,
                               logit_softcap)


class SCEGatherPLSE(torch.autograd.Function):
    """``plse (n_b, b_x)`` of ``(x_b, y, idx_y, tgt_b, cand_ids,
    logit_softcap)``; gradients for ``x_b`` and ``y``."""

    @staticmethod
    def forward(ctx, x_b, y, idx_y, tgt_b, cand_ids, logit_softcap):
        plse = sce_gather_plse_fwd(x_b, y, idx_y, tgt_b, cand_ids,
                                   logit_softcap=logit_softcap)
        ctx.save_for_backward(x_b, y, idx_y, tgt_b, cand_ids, plse)
        ctx.logit_softcap = logit_softcap
        return plse

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors + (g.contiguous(),)
        cap = ctx.logit_softcap
        need = ctx.needs_input_grad
        dx = sce_gather_plse_dx(*args, logit_softcap=cap) if need[0] else None
        dy = sce_gather_plse_dy(*args, logit_softcap=cap) if need[1] else None
        return dx, dy, None, None, None, None


def sce_gather_plse(x_b, y, idx_y, tgt_b, cand_ids, *, logit_softcap=None):
    """Partial in-bucket logsumexp (n_b, b_x) on the card, differentiable
    in ``x_b`` and ``y``; candidates with a negative ``cand_ids`` (padding,
    or rows another shard owns) are masked. See the module docstring."""
    return SCEGatherPLSE.apply(x_b, y, idx_y, tgt_b, cand_ids,
                               logit_softcap)
