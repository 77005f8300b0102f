"""In-bucket SCE over pre-gathered candidates, on the H100 — the wrappers
of the direct-addressed kernels of ``csrc/sce_gather.cu`` (port of
``sce_bucket_loss`` and ``sce_bucket_plse`` of
``repro/kernels/sce_bucket.py``).

The candidates arrive as ``y_b (n_b, b_y, d)``: candidate ``j`` of bucket
``n`` is row ``n·b_y + j``, with no index and no clamp. Otherwise the
kernels are ``kernels/sce_prefetch.py``'s (the same template with
``DIRECT`` set), one wrapper per launch, each with its own counter:

* :func:`sce_bucket_fwd` — per-(bucket, row) loss and logsumexp;
* :func:`sce_bucket_dx` — the gradient of ``x_b`` (n_b, b_x, d);
* :func:`sce_bucket_dy` — the gradient of ``y_b`` (n_b, b_y, d). Each
  bucket owns its ``y_b`` rows, so the kernel WRITES them (no
  ``atomicAdd``, unlike ``sce_gather_dy``): dY repeats bit for bit, and a
  candidate with a negative id gets an exact 0 row;
* :func:`sce_bucket_plse_fwd` — the partial logsumexp without the
  positive, from ``(NEG_INF, 0)``. Its backward is the loss's dX and dY
  launches with the plse in place of the lse, counted with the loss's
  (the reference's ``_plse_vjp_bwd`` calls the loss's ``_bwd`` too).

:class:`SCEBucketLoss` and :class:`SCEBucketPLSE` tie them together for
autograd, as ``sce_prefetch.py``'s classes do; the positive's cotangent
is ``d_pos = (exp(pos − lse) − 1)·g``. The wrappers take CUDA tensors
only; the CPU paths are ``kernels/ref.py::sce_bucket_loss_ref`` and
``sce_bucket_plse_ref``, chosen by ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sce_prefetch import MAX_D, _cap


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with the direct entries' C signatures declared
    (pointers and the stream as ``c_void_p``, ints as ``c_int``, the cap
    as ``c_float``)."""
    lib = _build.load("sce_gather")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("sce_bucket_fwd_launch", "sce_bucket_dx_launch",
                 "sce_bucket_dy_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 7 + [i] * 4 + [f, p]
        fn.restype = ctypes.c_int
    lib.sce_bucket_plse_fwd_launch.argtypes = [p] * 5 + [i] * 4 + [f, p]
    lib.sce_bucket_plse_fwd_launch.restype = ctypes.c_int
    return lib


def _check(x_b, y_b, tgt_b, cand_ids, *rows):
    """Device, type, shape and contiguity of one call; returns
    ``(n_b, b_x, b_y, d)``. ``rows`` are the (n_b, b_x) f32 inputs
    (``pos`` or ``lse`` and ``g``)."""
    tensors = (x_b, y_b, tgt_b, cand_ids) + rows
    if not all(t.is_cuda for t in tensors):
        raise ValueError("sce_bucket kernels take CUDA tensors only")
    if any(t.device != x_b.device for t in tensors):
        raise ValueError("sce_bucket inputs lie on different devices")
    if any(t.dtype != torch.float32 for t in (x_b, y_b) + rows):
        raise TypeError("sce_bucket takes float32 x_b, y_b, pos/lse and g")
    if any(t.dtype != torch.int32 for t in (tgt_b, cand_ids)):
        raise TypeError("sce_bucket takes int32 tgt_b and cand_ids")
    if x_b.ndim != 3 or y_b.ndim != 3 or x_b.shape[0] != y_b.shape[0] \
            or x_b.shape[2] != y_b.shape[2]:
        raise ValueError(f"need x_b (n_b, b_x, d), y_b (n_b, b_y, d); got "
                         f"{tuple(x_b.shape)}, {tuple(y_b.shape)}")
    n_b, b_x, d = x_b.shape
    b_y = y_b.shape[1]
    if cand_ids.shape != (n_b, b_y):
        raise ValueError(f"need cand_ids ({n_b}, {b_y}); got "
                         f"{tuple(cand_ids.shape)}")
    if any(t.shape != (n_b, b_x) for t in (tgt_b,) + rows):
        raise ValueError(f"tgt_b, pos/lse and g must be ({n_b}, {b_x})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sce_bucket takes contiguous tensors")
    if not 0 < d <= MAX_D:
        raise ValueError(f"d={d} outside (0, {MAX_D}]")
    if min(n_b, b_x, b_y) == 0:
        raise ValueError("sce_bucket needs non-empty buckets")
    if n_b * b_y > 2**31 - 1:
        raise ValueError(f"n_b·b_y = {n_b * b_y} overflows int32 rows")
    return n_b, b_x, b_y, d


def _launch(name, args, shape, device):
    n_b, b_x, b_y, d = shape
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_lib(), name)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args[:-1]],
            n_b, b_x, b_y, d, args[-1], stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err} (n_b={n_b}, "
                           f"b_x={b_x}, b_y={b_y}, d={d})")


def sce_bucket_fwd(x_b, y_b, tgt_b, cand_ids, pos_logit, *,
                   logit_softcap=None):
    """Forward kernel: ``(loss, lse)``, each (n_b, b_x) f32. ``pos_logit``
    arrives already capped; ``logit_softcap`` caps the in-bucket logits
    before the mask. Matches ``ref.sce_bucket_loss_ref``."""
    shape = _check(x_b, y_b, tgt_b, cand_ids, pos_logit)
    loss = torch.empty_like(pos_logit)
    lse = torch.empty_like(pos_logit)
    _launch("sce_bucket_fwd_launch",
            (x_b, y_b, tgt_b, cand_ids, pos_logit, loss, lse,
             _cap(logit_softcap)), shape, x_b.device)
    sce_bucket_fwd.launches += 1
    return loss, lse


def _bwd(kind, x_b, y_b, tgt_b, cand_ids, lse, g, cap):
    shape = _check(x_b, y_b, tgt_b, cand_ids, lse, g)
    out = torch.empty_like(x_b if kind == "dx" else y_b)
    _launch(f"sce_bucket_{kind}_launch",
            (x_b, y_b, tgt_b, cand_ids, lse, g, out, _cap(cap)), shape,
            x_b.device)
    return out


def sce_bucket_dx(x_b, y_b, tgt_b, cand_ids, lse, g, *, logit_softcap=None):
    """dX kernel: the (n_b, b_x, d) gradient of ``x_b`` for the upstream
    cotangent ``g`` (n_b, b_x) of the loss."""
    dx = _bwd("dx", x_b, y_b, tgt_b, cand_ids, lse, g, logit_softcap)
    sce_bucket_dx.launches += 1
    return dx


def sce_bucket_dy(x_b, y_b, tgt_b, cand_ids, lse, g, *, logit_softcap=None):
    """dY kernel: the (n_b, b_y, d) gradient of ``y_b``, every row written
    once by the block that owns it — bitwise repeatable."""
    dy = _bwd("dy", x_b, y_b, tgt_b, cand_ids, lse, g, logit_softcap)
    sce_bucket_dy.launches += 1
    return dy


def sce_bucket_plse_fwd(x_b, y_b, tgt_b, cand_ids, *, logit_softcap=None):
    """Partial-LSE forward kernel: (n_b, b_x) f32 logsumexp over the
    unmasked candidates alone, from ``(NEG_INF, 0)``; a row with every
    candidate masked is ``NEG_INF`` (−1e30), never ``−inf``. Matches
    ``ref.sce_bucket_plse_ref``."""
    shape = _check(x_b, y_b, tgt_b, cand_ids)
    plse = torch.empty(x_b.shape[:2], dtype=torch.float32,
                       device=x_b.device)
    _launch("sce_bucket_plse_fwd_launch",
            (x_b, y_b, tgt_b, cand_ids, plse, _cap(logit_softcap)), shape,
            x_b.device)
    sce_bucket_plse_fwd.launches += 1
    return plse


for _fn in (sce_bucket_fwd, sce_bucket_dx, sce_bucket_dy,
            sce_bucket_plse_fwd):
    _fn.launches = 0


class SCEBucketLoss(torch.autograd.Function):
    """``loss (n_b, b_x)`` of ``(x_b, y_b, tgt_b, cand_ids, pos_logit,
    logit_softcap)``; gradients for ``x_b``, ``y_b`` and ``pos_logit``."""

    @staticmethod
    def forward(ctx, x_b, y_b, tgt_b, cand_ids, pos_logit, logit_softcap):
        loss, lse = sce_bucket_fwd(x_b, y_b, tgt_b, cand_ids, pos_logit,
                                   logit_softcap=logit_softcap)
        ctx.save_for_backward(x_b, y_b, tgt_b, cand_ids, pos_logit, lse)
        ctx.logit_softcap = logit_softcap
        return loss

    @staticmethod
    def backward(ctx, g):
        x_b, y_b, tgt_b, cand_ids, pos_logit, lse = ctx.saved_tensors
        g = g.contiguous()
        args = (x_b, y_b, tgt_b, cand_ids, lse, g)
        cap = ctx.logit_softcap
        need = ctx.needs_input_grad
        dx = sce_bucket_dx(*args, logit_softcap=cap) if need[0] else None
        dy = sce_bucket_dy(*args, logit_softcap=cap) if need[1] else None
        d_pos = (torch.exp(pos_logit - lse) - 1.0) * g if need[4] else None
        return dx, dy, None, None, d_pos, None


def sce_bucket_loss(x_b, y_b, tgt_b, cand_ids, pos_logit, *,
                    logit_softcap=None):
    """In-bucket SCE losses (n_b, b_x) on the card over pre-gathered
    candidates, differentiable in ``x_b``, ``y_b`` and ``pos_logit``. See
    the module docstring."""
    return SCEBucketLoss.apply(x_b, y_b, tgt_b, cand_ids, pos_logit,
                               logit_softcap)


class SCEBucketPLSE(torch.autograd.Function):
    """``plse (n_b, b_x)`` of ``(x_b, y_b, tgt_b, cand_ids,
    logit_softcap)``; gradients for ``x_b`` and ``y_b`` by the loss's dX
    and dY launches (``gw = exp(l − plse)·g``)."""

    @staticmethod
    def forward(ctx, x_b, y_b, tgt_b, cand_ids, logit_softcap):
        plse = sce_bucket_plse_fwd(x_b, y_b, tgt_b, cand_ids,
                                   logit_softcap=logit_softcap)
        ctx.save_for_backward(x_b, y_b, tgt_b, cand_ids, plse)
        ctx.logit_softcap = logit_softcap
        return plse

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors + (g.contiguous(),)
        cap = ctx.logit_softcap
        need = ctx.needs_input_grad
        dx = sce_bucket_dx(*args, logit_softcap=cap) if need[0] else None
        dy = sce_bucket_dy(*args, logit_softcap=cap) if need[1] else None
        return dx, dy, None, None, None


def sce_bucket_plse(x_b, y_b, tgt_b, cand_ids, *, logit_softcap=None):
    """Partial in-bucket logsumexp (n_b, b_x) on the card over
    pre-gathered candidates, differentiable in ``x_b`` and ``y_b``;
    candidates with a negative ``cand_ids`` are masked."""
    return SCEBucketPLSE.apply(x_b, y_b, tgt_b, cand_ids, logit_softcap)
