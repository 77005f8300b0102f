"""In-bucket SCE with the candidates gathered from the catalog, on the
H100 — the wrappers of ``csrc/sce_gather.cu`` (port of ``sce_gather_loss``
and ``sce_gather_plse`` of ``repro/kernels/sce_prefetch.py``).

The loss, one wrapper per kernel, each with its own launch counter:

* :func:`sce_gather_fwd` — per-(bucket, row) loss and logsumexp;
* :func:`sce_gather_dx` — the gradient of ``x_b`` (n_b, b_x, d);
* :func:`sce_gather_dy` — the gradient of the whole catalog ``y`` (C, d):
  the dY kernel writes each (bucket, slot)'s row into an
  ``(n_b·b_y, d)`` workspace, and :func:`sce_gather_dy_sum` (a kernel
  with its own counter) adds the rows that share a catalog row in
  ascending (bucket, slot) order, the reference's order, after a stable
  sort of the slots' rows (:func:`dy_sum_keys`, PyTorch glue) — bitwise
  repeatable, rows no bucket selected exactly 0.

The forward, dX and dY take their logits on the tensor cores in 3xTF32
(``csrc/tf32x3_tile.cuh``) with the same arithmetic, so the forward's
lse comes from the logits the backward recomputes; the 3xTF32 products
hold the f32 tolerance. The backward's exp takes ``min(l − lse, 44)``,
the one deviation from the plain version (see the source).
:func:`fwd_plan` and :func:`bwd_plan` are the launch plans without a
card, :func:`planned_smem` the guard's budget.

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

Above ``MAX_D`` (:func:`is_deep`) every wrapper launches the source's
deep variant (``*_deep_launch``): the logits are written once into an
``(n_b, b_x, b_y)`` f32 workspace by ``csrc/deep_tc.cuh``'s 3xTF32
product over depth chunks of 32 (bf16 operands: its bf16 ``wgmma``
product, ``gemm_bf16``), then folded (the forward), or, in one backward
launch, recomputed with the same product, turned into the cotangent
once and multiplied back into dX and dY's slot rows — both from that
one cotangent when autograd needs both (bf16 operands: the cotangent
rounded once into a bf16 buffer, :func:`_cotangent_ws`).

``x_b`` and ``y`` are float32 or both bfloat16 (``deep.operand_dtype``),
as the reference's kernels take them: bf16 operands are read as stored
(widened to f32 in the resident kernels, taken as bf16 by the deep
product), every product accumulates in f32, and dX and dY round their
cotangent to bf16 before the second product (the reference's
``gw.astype(tile.dtype)``). The outputs keep the reference's types: loss
in ``pos_logit``'s, lse and plse f32, dX in ``x_b``'s and dY in ``y``'s
— accumulated in f32 (the gathered dY's workspace and each row's
in-order sum too) and rounded once at the end; a bf16 catalog's dY is
written as bf16 by the sum itself, no f32 ``(C, d)`` table. The per-row
inputs (``pos_logit``, ``g``) go to the kernels as f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.deep import (DEEP_SMEM, MAX_D, bf16_flag,
                                      f32_like, f32_rows, is_deep,
                                      operand_dtype)
from repro_torch.kernels.linear_sce import MAX_SMEM, padded_depth

STREAM_ROWS = 32  # kStreamRows: rows of a streamed backward tile
STAGES = 3  # kStages: the backward's raw ring


FWD_MAX_WARPS = 10  # kFwdMaxWarps: 32 positions a warp
FWD_TILE = 64  # kFwdTile: candidates a warp folds at a time
FWD_MAX_ROWS = 256  # kFwdMaxRows: resident candidates at most
SM_SMEM = 233_472  # kSmSmem: an SM's shared memory, of which ...
BLOCK_SMEM = 1_024  # kBlockSmem: ... each block reserves this much


def fwd_plan(d: int):
    """``(warps, smem bytes, chunk rows)`` of the forward launch at depth
    d, a copy of ``fwd_plan`` in ``csrc/sce_gather.cu`` that needs no card
    (:func:`library_fwd_plan` reads the kernel's own; the CUDA tests and
    ``chip_smoke.py`` hold the two equal): 32 positions a warp and a chunk
    of candidates, both resident as raw rows (4 bytes a depth at a pitch
    of ``dp`` rounded up to 32), with the candidates' ids and source rows.
    Five warps and 256 candidates where two such blocks share an SM (up to
    ``dp`` 64); else the most warps (up to ten) that leave room for 64
    candidates, one block an SM."""
    dp = padded_depth(d)
    pitch = -(-dp // 32) * 32
    row, pos = 4 * pitch + 8, 4 * pitch * 32
    two = 5 * pos + row * FWD_MAX_ROWS
    if 2 * (two + BLOCK_SMEM) <= SM_SMEM:
        return 5, two, FWD_MAX_ROWS
    for warps in range(FWD_MAX_WARPS, 1, -1):
        own = pos * warps
        if own + row * FWD_TILE > MAX_SMEM:
            continue
        rows = min((MAX_SMEM - own) // row // FWD_TILE * FWD_TILE,
                   FWD_MAX_ROWS)
        return warps, own + row * rows, rows
    return 1, pos + row * FWD_TILE, FWD_TILE


def library_fwd_plan(d: int):
    """``(warps, smem bytes, chunk rows)`` as the built library plans the
    forward (``sce_gather_fwd_plan``)."""
    warps, rows = ctypes.c_int(), ctypes.c_int()
    smem = _lib().sce_gather_fwd_plan(d, ctypes.byref(warps),
                                      ctypes.byref(rows))
    if smem < 0:
        raise ValueError(f"sce_gather_fwd_plan: d={d} outside (0, {MAX_D}]")
    return warps.value, smem, rows.value


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
    """Shared memory per block of the largest launch at depth d: the
    forward's (:func:`fwd_plan`) or dX / dY's (:func:`bwd_plan`), or the
    deep variant's product (``DEEP_SMEM`` at every d). The kernel guard
    checks it against the 227 KB a block may use."""
    if is_deep(d):
        return DEEP_SMEM
    return max(fwd_plan(d)[1], bwd_plan(d)[1])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as ``c_void_p``, ints as ``c_int``, the cap as ``c_float``)."""
    lib = _build.load("sce_gather")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("sce_gather_fwd_launch", "sce_gather_dx_launch",
                 "sce_gather_dy_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 8 + [i] * 5 + [f, i, p]
        fn.restype = ctypes.c_int
    lib.sce_gather_plse_fwd_launch.argtypes = [p] * 6 + [i] * 5 + [f, i, p]
    lib.sce_gather_plse_fwd_launch.restype = ctypes.c_int
    lib.sce_gather_bwd_plan.argtypes = [i, p]
    lib.sce_gather_bwd_plan.restype = ctypes.c_int
    lib.sce_gather_fwd_plan.argtypes = [i, p, p]
    lib.sce_gather_fwd_plan.restype = ctypes.c_int
    lib.sce_gather_dy_sum_launch.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.sce_gather_dy_sum_launch.restype = ctypes.c_int
    lib.sce_gather_fwd_deep_launch.argtypes = [p] * 9 + [i] * 5 + [f, i, p]
    lib.sce_gather_fwd_deep_launch.restype = ctypes.c_int
    lib.sce_gather_bwd_deep_launch.argtypes = [p] * 11 + [i] * 5 + [f, i, p]
    lib.sce_gather_bwd_deep_launch.restype = ctypes.c_int
    lib.sce_gather_plse_fwd_deep_launch.argtypes = ([p] * 7 + [i] * 5
                                                    + [f, i, p])
    lib.sce_gather_plse_fwd_deep_launch.restype = ctypes.c_int
    return lib


def _check(x_b, y, idx_y, tgt_b, cand_ids, *rows):
    """Device, type, shape and contiguity of one call; returns
    ``(n_b, b_x, b_y, C, d)``. ``rows`` are the (n_b, b_x) f32 inputs
    (``pos`` or ``lse`` and ``g``, as ``deep.f32_rows`` passes them)."""
    tensors = (x_b, y, idx_y, tgt_b, cand_ids) + rows
    if not all(t.is_cuda for t in tensors):
        raise ValueError("sce_gather kernels take CUDA tensors only")
    if any(t.device != x_b.device for t in tensors):
        raise ValueError("sce_gather inputs lie on different devices")
    operand_dtype("sce_gather", x_b, y)
    if any(t.dtype != torch.float32 for t in rows):
        raise TypeError("sce_gather takes float32 pos/lse and g")
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
    if not d > 0:
        raise ValueError("sce_gather needs d > 0")
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


def _logits_ws(shape, device):
    """The deep entries' ``(n_b, b_x, b_y)`` f32 workspace, flat."""
    n_b, b_x, b_y = shape[:3]
    return torch.empty(n_b * b_x * b_y, dtype=torch.float32, device=device)


def _cotangent_ws(shape, dtype, device):
    """The deep backward's bf16 cotangent for bf16 operands, ``(n_b·b_x,
    b_y)`` at a row pitch of ``b_y`` rounded up to 8 (rows 16-byte
    aligned, as the bf16 product's TMA takes them), flat; None for f32
    operands, whose cotangent overwrites the logits workspace."""
    if dtype != torch.bfloat16:
        return None
    n_b, b_x, b_y = shape[:3]
    return torch.empty(n_b * b_x * (-(-b_y // 8) * 8), dtype=dtype,
                       device=device)


def _launch_fwd(name, args, shape, device):
    """A forward launch; above ``MAX_D`` the deep entry with its logits
    workspace."""
    if is_deep(shape[-1]):
        name = name.replace("_launch", "_deep_launch")
        args = args[:-1] + (_logits_ws(shape, device), args[-1])
    _launch(name, args, shape, device)


def _launch(name, args, shape, device):
    """``args``: the pointers' tensors (x_b first, whose type is the
    operands'), then the cap."""
    n_b, b_x, b_y, c, d = shape
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_lib(), name)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args[:-1]],
            n_b, b_x, b_y, c, d, args[-1], bf16_flag(args[0].dtype), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{name} failed: cudaError {err} (n_b={n_b}, b_x={b_x}, "
            f"b_y={b_y}, C={c}, d={d})"
        )


def sce_gather_fwd(x_b, y, idx_y, tgt_b, cand_ids, pos_logit, *,
                   logit_softcap=None):
    """Forward kernel: ``(loss, lse)``, each (n_b, b_x): loss in
    ``pos_logit``'s type, lse f32. ``pos_logit`` arrives already capped;
    ``logit_softcap`` caps the in-bucket logits before the mask. Matches
    ``ref.sce_gather_loss_ref``."""
    pos, = f32_rows(pos_logit)
    shape = _check(x_b, y, idx_y, tgt_b, cand_ids, pos)
    loss = torch.empty_like(pos)
    lse = torch.empty_like(pos)
    _launch_fwd("sce_gather_fwd_launch",
                (x_b, y, idx_y, tgt_b, cand_ids, pos, loss, lse,
                 _cap(logit_softcap)), shape, x_b.device)
    sce_gather_fwd.launches += 1
    return loss.to(pos_logit.dtype), lse


def _bwd(x_b, y, idx_y, tgt_b, cand_ids, lse, g, cap, want_dx, want_dy):
    """``(dx, dy)``, each None unless wanted: dX (n_b, b_x, d), and dY in
    two kernels — each slot's row into the ``(n_b·b_y, d)`` workspace (an
    exact 0 row for a negative id), then :func:`sce_gather_dy_sum` into
    the zeroed ``(C, d)``. At ``d ≤ MAX_D`` the resident dX and dY
    kernels, a launch each; above, one deep launch that writes the
    logits' cotangent once and runs both products from it. Both are
    computed in f32 and returned in ``x_b``'s and ``y``'s types: dX
    rounded here, dY by the sum into a table of ``y``'s type."""
    lse, g = f32_rows(lse, g)
    shape = _check(x_b, y, idx_y, tgt_b, cand_ids, lse, g)
    n_b, _, b_y, c, d = shape
    dx = f32_like(x_b, want_dx)
    ws = (torch.empty(n_b * b_y, d, dtype=torch.float32, device=x_b.device)
          if want_dy else None)
    head, cap = (x_b, y, idx_y, tgt_b, cand_ids, lse, g), _cap(cap)
    if is_deep(d):
        _launch("sce_gather_bwd_deep_launch",
                head + (dx, ws, _logits_ws(shape, x_b.device),
                        _cotangent_ws(shape, x_b.dtype, x_b.device), cap),
                shape, x_b.device)
    else:
        if want_dx:
            _launch("sce_gather_dx_launch", head + (dx, cap), shape,
                    x_b.device)
        if want_dy:
            _launch("sce_gather_dy_launch", head + (ws, cap), shape,
                    x_b.device)
    dy = (sce_gather_dy_sum(ws, *dy_sum_keys(idx_y, cand_ids, c),
                            torch.zeros_like(y))
          if want_dy else None)
    return None if dx is None else dx.to(x_b.dtype), dy


def _grads(dx_fn, dy_fn, args, cap, want_dx, want_dy):
    """:func:`_bwd` counted on the wrappers ``dx_fn`` / ``dy_fn`` (one
    each for the kernel it launched): what autograd's backward runs, so
    above ``MAX_D`` a step that needs both writes the cotangent once."""
    dx, dy = _bwd(*args, cap, want_dx, want_dy)
    dx_fn.launches += want_dx
    dy_fn.launches += want_dy
    return dx, dy


def dy_sum_keys(idx_y, cand_ids, c):
    """``(keys, order)`` of :func:`sce_gather_dy_sum`, PyTorch glue: the
    flat slots' catalog rows clamped to ``[0, C)``, ``C`` for a slot with
    a negative id (it adds nothing and sorts last), sorted stably, and the
    slot of each (ascending within a row)."""
    rows = torch.where(cand_ids.reshape(-1) < 0, c,
                       idx_y.reshape(-1).clamp(0, c - 1))
    return torch.sort(rows, stable=True)


def sce_gather_dy_sum(ws, keys, order, dy):
    """The gathered dY's sum kernel: adds the workspace rows ``ws
    (n_slots, d)`` into ``dy (C, d)`` (zeroed by the caller) per catalog
    row, from 0 in ascending slot order; ``(keys, order)`` from
    :func:`dy_sum_keys` (keys ``C`` add nothing). ``dy`` f32, or bf16
    (a bf16 catalog's gradient: each row's f32 sum rounded once, no f32
    table). Writes ``dy`` in place and returns it; :func:`dy_sum_plain`
    is its plain version."""
    n_slots, d = ws.shape
    tensors = (ws, keys, order, dy)
    if not all(t.is_cuda and t.device == ws.device for t in tensors):
        raise ValueError("sce_gather_dy_sum takes CUDA tensors on one device")
    if (ws.dtype, keys.dtype, order.dtype) != (
            torch.float32, torch.int32, torch.int64) or \
            dy.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("sce_gather_dy_sum takes f32 ws, f32 or bf16 dy, "
                        "i32 keys, i64 order")
    if (keys.numel(), order.numel()) != (n_slots,) * 2 or dy.ndim != 2 \
            or dy.shape[1] != d:
        raise ValueError("sce_gather_dy_sum: ws (n_slots, d), keys and "
                         "order (n_slots,), dy (C, d)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sce_gather_dy_sum takes contiguous tensors")
    with torch.cuda.device(ws.device):
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        err = _lib().sce_gather_dy_sum_launch(
            *(t.data_ptr() for t in tensors), n_slots, d, dy.shape[0],
            bf16_flag(dy.dtype), stream)
    if err != 0:
        raise RuntimeError(f"sce_gather_dy_sum_launch failed: cudaError "
                           f"{err} (n_slots={n_slots}, d={d})")
    sce_gather_dy_sum.launches += 1
    return dy


def dy_sum_plain(ws, idx_y, cand_ids, c, dtype=None):
    """The plain version of :func:`sce_gather_dy_sum`: the workspace rows
    of the slots with a non-negative id added into a ``(C, d)`` zero
    tensor at their clamped catalog rows (``index_add_``; on the card its
    order of addition is not fixed), in ``ws``'s type, then rounded once
    to ``dtype`` when given (a bf16 table)."""
    keep = cand_ids.reshape(-1) >= 0
    rows = idx_y.reshape(-1).long().clamp(0, c - 1)[keep]
    out = ws.new_zeros(c, ws.shape[1]).index_add_(0, rows, ws[keep])
    return out if dtype is None else out.to(dtype)


def sce_gather_dx(x_b, y, idx_y, tgt_b, cand_ids, lse, g, *,
                  logit_softcap=None):
    """dX kernel: the (n_b, b_x, d) gradient of ``x_b`` for the upstream
    cotangent ``g`` (n_b, b_x) of the loss."""
    return _grads(sce_gather_dx, sce_gather_dy,
                  (x_b, y, idx_y, tgt_b, cand_ids, lse, g), logit_softcap,
                  True, False)[0]


def sce_gather_dy(x_b, y, idx_y, tgt_b, cand_ids, lse, g, *,
                  logit_softcap=None):
    """dY kernel: the (C, d) gradient of the catalog ``y``; each selected
    row ``idx_y[n, j]`` receives the sum over buckets in ascending
    (bucket, slot) order, every other row is exactly 0 (bitwise
    repeatable). Counts this launch; the sum's launch is counted by
    :func:`sce_gather_dy_sum`."""
    return _grads(sce_gather_dx, sce_gather_dy,
                  (x_b, y, idx_y, tgt_b, cand_ids, lse, g), logit_softcap,
                  False, True)[1]


def sce_gather_plse_fwd(x_b, y, idx_y, tgt_b, cand_ids, *,
                        logit_softcap=None):
    """Partial-LSE forward kernel: (n_b, b_x) f32 logsumexp over the
    unmasked candidates alone, from ``(NEG_INF, 0)``; a row with every
    candidate masked is ``NEG_INF`` (−1e30), never ``−inf``. Matches
    ``ref.sce_gather_plse_ref``."""
    shape = _check(x_b, y, idx_y, tgt_b, cand_ids)
    plse = torch.empty(tuple(x_b.shape[:2]), dtype=torch.float32,
                       device=x_b.device)
    _launch_fwd("sce_gather_plse_fwd_launch",
                (x_b, y, idx_y, tgt_b, cand_ids, plse, _cap(logit_softcap)),
                shape, x_b.device)
    sce_gather_plse_fwd.launches += 1
    return plse


def sce_gather_plse_dx(x_b, y, idx_y, tgt_b, cand_ids, plse, g, *,
                       logit_softcap=None):
    """The dX kernel for the partial LSE: ``gw = exp(l − plse)·g``, 0
    where masked, so a row with no unmasked candidate gets exactly 0."""
    return _grads(sce_gather_plse_dx, sce_gather_plse_dy,
                  (x_b, y, idx_y, tgt_b, cand_ids, plse, g), logit_softcap,
                  True, False)[0]


def sce_gather_plse_dy(x_b, y, idx_y, tgt_b, cand_ids, plse, g, *,
                       logit_softcap=None):
    """The dY kernel for the partial LSE (a workspace and its in-order
    sum, as :func:`sce_gather_dy`)."""
    return _grads(sce_gather_plse_dx, sce_gather_plse_dy,
                  (x_b, y, idx_y, tgt_b, cand_ids, plse, g), logit_softcap,
                  False, True)[1]


for _fn in (sce_gather_fwd, sce_gather_dx, sce_gather_dy,
            sce_gather_plse_fwd, sce_gather_plse_dx, sce_gather_plse_dy,
            sce_gather_dy_sum):
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
        dx, dy = _grads(sce_gather_dx, sce_gather_dy, args, cap, need[0],
                        need[1])
        d_pos = (((torch.exp(pos_logit.float() - lse) - 1.0) * g.float())
                 .to(pos_logit.dtype) if need[5] else None)
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
        dx, dy = _grads(sce_gather_plse_dx, sce_gather_plse_dy, args, cap,
                        need[0], need[1])
        return dx, dy, None, None, None, None


def sce_gather_plse(x_b, y, idx_y, tgt_b, cand_ids, *, logit_softcap=None):
    """Partial in-bucket logsumexp (n_b, b_x) on the card, differentiable
    in ``x_b`` and ``y``; candidates with a negative ``cand_ids`` (padding,
    or rows another shard owns) are masked. See the module docstring."""
    return SCEGatherPLSE.apply(x_b, y, idx_y, tgt_b, cand_ids,
                               logit_softcap)
