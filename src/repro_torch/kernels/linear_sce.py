"""Full-catalog cross-entropy streamed over the catalog, on the H100 — the
wrappers of ``csrc/linear_ce.cu`` (port of ``linear_ce_loss`` of
``repro/kernels/linear_sce.py``).

Three kernels, one wrapper each, each with its own launch counter:

* :func:`linear_ce_fwd` — per-position ``(loss, lse)``, the target's
  (capped) logit plucked inside the sweep;
* :func:`linear_ce_dx` — the gradient of ``x`` (N, d);
* :func:`linear_ce_dw` — the gradient of the head/catalog ``w`` (C, d),
  every row written once (no atomics: bitwise repeatable).

:class:`LinearCELoss` ties them together for autograd: the forward saves
``x``, ``w``, ``targets`` and ``lse``; the backward recomputes the capped
logit tiles, so the ``(N, C)`` logits never exist. ``kernels/fused_ce.py``
runs the same kernels without the pluck and the one-hot (``_fwd``,
``_dx``, ``_dw`` below). The wrappers take CUDA tensors only; the CPU
path is ``kernels/ref.py``, chosen by ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_D = 256  # kMaxD in csrc/f32_tile.cuh


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as ``c_void_p``, ints as ``c_int``, the cap as ``c_float``)."""
    lib = _build.load("linear_ce")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.linear_ce_splits.argtypes = [i] * 5 + [f]
    lib.linear_ce_fwd_launch.argtypes = [p] * 6 + [i] * 5 + [f, p]
    lib.linear_ce_dx_launch.argtypes = [p] * 7 + [i] * 5 + [f, p]
    lib.linear_ce_dw_launch.argtypes = [p] * 6 + [i] * 4 + [f, p]
    for fn in (lib.linear_ce_splits, lib.linear_ce_fwd_launch,
               lib.linear_ce_dx_launch, lib.linear_ce_dw_launch):
        fn.restype = ctypes.c_int
    return lib


def _check(x, w, targets, *rows):
    """Device, type, shape and contiguity of one call; returns
    ``(N, C, d)``. ``targets`` may be None (no pluck); ``rows`` are the
    (N,) f32 inputs (``lse`` and ``g``)."""
    tensors = (x, w) + (() if targets is None else (targets,)) + rows
    if not all(t.is_cuda for t in tensors):
        raise ValueError("linear_ce kernels take CUDA tensors only")
    if any(t.device != x.device for t in tensors):
        raise ValueError("linear_ce inputs lie on different devices")
    if any(t.dtype != torch.float32 for t in (x, w) + rows):
        raise TypeError("linear_ce takes float32 x, w, lse and g")
    if targets is not None and targets.dtype != torch.int32:
        raise TypeError("linear_ce takes int32 targets")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x (N, d), w (C, d); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    n, d = x.shape
    c = w.shape[0]
    vecs = (() if targets is None else (targets,)) + rows
    if any(t.shape != (n,) for t in vecs):
        raise ValueError(f"targets, lse and g must be ({n},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("linear_ce takes contiguous tensors")
    if not 0 < d <= MAX_D:
        raise ValueError(f"d={d} outside (0, {MAX_D}]")
    if n == 0 or c == 0:
        raise ValueError("linear_ce needs positions and a catalog")
    return n, c, d


def _cap(logit_softcap) -> float:
    if logit_softcap is None:
        return 0.0
    if not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    return float(logit_softcap)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(name, args, shape, device):
    """Calls ``name`` with ``args`` and the current stream on ``device``;
    raises on a non-zero cudaError."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_lib(), name)(*args, stream)
    if err != 0:
        n, c, d = shape
        raise RuntimeError(f"{name} failed: cudaError {err} (N={n}, C={c}, "
                           f"d={d})")


@functools.lru_cache(maxsize=None)
def _splits(kind: int, n: int, c: int, d: int, pluck: bool, cap: float,
            device: torch.device) -> int:
    """The catalog splits the forward (kind 0) or dX (kind 1) runs at on
    ``device``, from the kernel's own plan (occupancy and SM count)."""
    with torch.cuda.device(device):
        s = _lib().linear_ce_splits(kind, n, c, d, int(pluck), cap)
    if s < 1:
        raise RuntimeError(f"linear_ce_splits failed: cudaError {-s} "
                           f"(N={n}, C={c}, d={d})")
    return s


def _fwd(x, w, targets, logit_softcap):
    """``(loss or None, lse)``: with ``targets`` the plucked loss too."""
    shape = _check(x, w, targets)
    n = shape[0]
    cap = _cap(logit_softcap)
    pluck = targets is not None
    s = _splits(0, *shape, pluck, cap, x.device)
    part = torch.empty((s, n, 3), dtype=torch.float32, device=x.device)
    lse = torch.empty((n,), dtype=torch.float32, device=x.device)
    loss = torch.empty_like(lse) if pluck else None
    _call("linear_ce_fwd_launch",
          (x.data_ptr(), w.data_ptr(), _ptr(targets), part.data_ptr(),
           _ptr(loss), lse.data_ptr(), *shape, s, int(pluck), cap),
          shape, x.device)
    return loss, lse


def _dx(x, w, targets, lse, g, logit_softcap):
    shape = _check(x, w, targets, lse, g)
    n, _, d = shape
    cap = _cap(logit_softcap)
    pluck = targets is not None
    s = _splits(1, *shape, pluck, cap, x.device)
    part = (torch.empty((s, n, d), dtype=torch.float32, device=x.device)
            if s > 1 else None)
    dx = torch.empty_like(x)
    _call("linear_ce_dx_launch",
          (x.data_ptr(), w.data_ptr(), _ptr(targets), lse.data_ptr(),
           g.data_ptr(), _ptr(part), dx.data_ptr(), *shape, s, int(pluck),
           cap), shape, x.device)
    return dx


def _dw(x, w, targets, lse, g, logit_softcap):
    shape = _check(x, w, targets, lse, g)
    dw = torch.empty_like(w)
    _call("linear_ce_dw_launch",
          (x.data_ptr(), w.data_ptr(), _ptr(targets), lse.data_ptr(),
           g.data_ptr(), dw.data_ptr(), *shape, int(targets is not None),
           _cap(logit_softcap)), shape, x.device)
    return dw


def linear_ce_fwd(x, w, targets, *, logit_softcap=None):
    """Forward kernel: ``(loss, lse)``, each (N,) f32; ``loss = lse −`` the
    target's capped logit (a target outside ``[0, C)`` plucks 0). Matches
    ``ref.linear_ce_loss_ref``."""
    loss, lse = _fwd(x, w, targets, logit_softcap)
    linear_ce_fwd.launches += 1
    return loss, lse


def linear_ce_dx(x, w, targets, lse, g, *, logit_softcap=None):
    """dX kernel: the (N, d) gradient of ``x`` for the upstream cotangent
    ``g`` (N,) of the loss."""
    dx = _dx(x, w, targets, lse, g, logit_softcap)
    linear_ce_dx.launches += 1
    return dx


def linear_ce_dw(x, w, targets, lse, g, *, logit_softcap=None):
    """dW kernel: the (C, d) gradient of ``w``, each row written once."""
    dw = _dw(x, w, targets, lse, g, logit_softcap)
    linear_ce_dw.launches += 1
    return dw


linear_ce_fwd.launches = 0
linear_ce_dx.launches = 0
linear_ce_dw.launches = 0


class LinearCELoss(torch.autograd.Function):
    """``loss (N,)`` of ``(x, w, targets, logit_softcap)``; gradients for
    ``x`` and ``w`` (the targets get none)."""

    @staticmethod
    def forward(ctx, x, w, targets, logit_softcap):
        loss, lse = linear_ce_fwd(x, w, targets, logit_softcap=logit_softcap)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.logit_softcap = logit_softcap
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        g = g.contiguous()
        cap = ctx.logit_softcap
        need = ctx.needs_input_grad
        dx = (linear_ce_dx(x, w, targets, lse, g, logit_softcap=cap)
              if need[0] else None)
        dw = (linear_ce_dw(x, w, targets, lse, g, logit_softcap=cap)
              if need[1] else None)
        return dx, dw, None, None


def linear_ce_loss(x, w, targets, *, logit_softcap=None):
    """Per-position full-catalog CE (N,) on the card from hidden states
    ``x`` (N, d) and the table ``w`` (C, d), differentiable in both; the
    ``(N, C)`` logits never exist, forward or backward. See the module
    docstring."""
    return LinearCELoss.apply(x.contiguous(), w.contiguous(),
                              targets.to(torch.int32).contiguous(),
                              logit_softcap)
