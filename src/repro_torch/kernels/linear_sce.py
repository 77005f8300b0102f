"""Full-catalog cross-entropy streamed over the catalog, on the H100 — the
wrappers of ``csrc/linear_ce.cu`` (port of ``linear_ce_loss`` of
``repro/kernels/linear_sce.py``).

Four kernels, one wrapper each, each with its own launch counter:

* :func:`linear_ce_split` — the ``(hi, lo)`` TF32 planes of ``x`` and
  ``w``, ``(rows, dp / 8, 2, 8)`` with ``dp`` = d rounded up to 16, which
  the three others read;
* :func:`linear_ce_fwd` — per-position ``(loss, lse)``, the target's
  (capped) logit plucked inside the sweep;
* :func:`linear_ce_dx` — the gradient of ``x`` (N, d);
* :func:`linear_ce_dw` — the gradient of the head/catalog ``w`` (C, d),
  every row written once (no atomics: bitwise repeatable).

The forward, dX and dW run their products on the tensor cores in 3xTF32
from the planes (``csrc/tf32x3_tile.cuh``). :class:`LinearCELoss` ties
them together for autograd: the forward splits ``x`` and ``w`` once,
sweeps the catalog and saves ``x``, ``w``, ``targets``, ``lse`` and the
planes; the backward passes the same planes to both gradients, which
recompute the capped logit tiles, so the ``(N, C)`` logits never exist.
``kernels/fused_ce.py`` runs the same kernels without the pluck and the
one-hot (``_fwd``, ``_dx``, ``_dw`` below). The wrappers take CUDA
tensors only; the CPU path is ``kernels/ref.py``, chosen by
``kernels/ops.py``.

Above ``MAX_D`` (:func:`is_deep`) the same wrappers launch the deep
entries of ``csrc/linear_ce.cu``: no planes; the catalog in chunks of
:func:`deep_chunk` rows, each chunk's ``(N, chunk)`` logits written into
a slab by ``csrc/deep_tc.cuh``'s 3xTF32 product (bf16 operands: its
bf16 ``wgmma`` product, ``gemm_bf16``) and folded (the forward), or
recomputed, turned into the cotangent once and multiplied back into dX
(accumulated over the chunks in order) and dW's chunk rows — both from
one launch when autograd needs both.

``x`` and ``w`` are float32 or both bfloat16 (``deep.operand_dtype``):
the split widens bf16 rows into planes whose lo is 0, which the forward,
dX and dW then read in one TF32 pass a product (their lo passes would
add zeros); the deep products read them as stored at the bf16 rate, the
backward's cotangent rounded once into a bf16 slab beside the f32
logits (:func:`_cotangent_slab`). Both backwards round the cotangent to
bf16 before its product (the reference's ``gw.astype(w.dtype)``).
Outputs keep the reference's types: the loss in
``x``'s, the lse f32, dX in ``x``'s and dW in ``w``'s, accumulated in f32
and rounded once. ``lse`` and ``g`` go to the kernels as f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.deep import (DEEP_SMEM, MAX_D, bf16_flag,
                                      f32_like, f32_rows, is_deep,
                                      operand_dtype, slab_rows)

DEPTH_ALIGN = 16  # kDepthAlign in csrc/tf32x3_tile.cuh
MAX_SMEM = 232_448  # a block's opt-in shared memory on sm_90
PAIR_SMEM = 233_472 // 2 - 1024  # two blocks an SM, 1 KB reserved each
FWD_MAX_WARPS = 8  # kFwdMaxWarps in csrc/linear_ce.cu


def deep_chunk(n: int, c: int, dtype=torch.float32) -> int:
    """Catalog rows a deep call's slab holds: ``deep.slab_rows`` of the
    catalog against ``n`` positions, a multiple of 4 (the slab's rows
    start 16-byte aligned) and of 128 from there up, its ``(n, chunk)``
    f32 slab — on bf16 operands with the backward's ``(n, chunk)`` bf16
    cotangent beside it — within ``deep.SLAB_BYTES``."""
    return slab_rows(c, n, multiple=4,
                     entry_bytes=6 if dtype == torch.bfloat16 else 4)


def padded_depth(d: int) -> int:
    """The planes' depth: d rounded up to 16 (whole 128-byte lines)."""
    return -(-d // DEPTH_ALIGN) * DEPTH_ALIGN


def fwd_rows(d: int) -> int:
    """Catalog rows of the forward's streamed tile at depth d: 64 up to
    ``dp`` 64, else 32."""
    return 64 if padded_depth(d) <= 64 else 32


def fwd_plan(d: int):
    """``(warps, stages, smem bytes)`` of the forward's launch at depth d,
    a copy of ``fwd_plan`` in ``csrc/linear_ce.cu`` that needs no card
    (:func:`library_fwd_plan` reads the kernel's own; the CUDA tests and
    ``chip_smoke.py`` hold the two equal): the most warps (at most eight,
    32 owned positions of (hi, lo) pairs each) that fit one block's shared
    memory beside a ring of :func:`fwd_rows`-row streamed tiles, three
    stages unless two fit more warps."""
    dp = padded_depth(d)
    own, stage = 8 * dp * 32, 8 * dp * fwd_rows(d)
    warps, stages = 0, 3
    for st in (3, 2):
        fit = min(FWD_MAX_WARPS, max(0, (MAX_SMEM - st * stage) // own))
        if fit > warps:
            warps, stages = fit, st
    return warps, stages, own * warps + stage * stages


def library_fwd_plan(d: int):
    """``(warps, stages, smem bytes)`` as the built library plans the
    forward (``linear_ce_fwd_plan``)."""
    warps, stages = ctypes.c_int(), ctypes.c_int()
    smem = _lib().linear_ce_fwd_plan(d, ctypes.byref(warps),
                                     ctypes.byref(stages))
    if smem < 0:
        raise ValueError(f"linear_ce_fwd_plan: d={d} outside (0, {MAX_D}]")
    return warps.value, stages.value, smem


def bwd_plan(d: int, dw: bool):
    """``(warps, stages, smem bytes)`` of the dX (``dw`` False) or dW
    launch at depth d, a copy of ``bwd_plan`` in ``csrc/linear_ce.cu``
    that needs no card (:func:`library_bwd_plan` reads the kernel's own;
    the CUDA tests and ``chip_smoke.py`` hold the two equal): 32 owned
    rows of (hi, lo) pairs a warp (four warps up to dp 128, two to 192,
    else one), a ring of 32-row streamed tiles (three stages where two
    blocks still share an SM, else two where that lets them, else three
    if they fit), dW's tiles with their positions' lse, g and targets."""
    dp = padded_depth(d)
    warps = 4 if dp <= 128 else (2 if dp <= 192 else 1)

    def nbytes(stages):
        return 8 * dp * (32 * warps + 32 * stages) + (
            12 * 32 * stages if dw else 0)

    stages = 3
    if nbytes(3) > PAIR_SMEM and (nbytes(2) <= PAIR_SMEM
                                  or nbytes(3) > MAX_SMEM):
        stages = 2
    return warps, stages, nbytes(stages)


def library_bwd_plan(d: int, dw: bool):
    """``(warps, stages, smem bytes)`` as the built library plans them
    (``linear_ce_bwd_plan``)."""
    warps, stages = ctypes.c_int(), ctypes.c_int()
    smem = _lib().linear_ce_bwd_plan(d, int(dw), ctypes.byref(warps),
                                     ctypes.byref(stages))
    if smem < 0:
        raise ValueError(f"linear_ce_bwd_plan: d={d} outside (0, {MAX_D}]")
    return warps.value, stages.value, smem


def planned_smem(d: int) -> int:
    """Dynamic shared memory per block of the largest of the launches at
    depth d: the forward's or the backward's owned planes and ring
    (:func:`fwd_plan`, :func:`bwd_plan`), or the deep variant's product
    (``DEEP_SMEM`` at every d). The kernel guard checks it against the
    227 KB a block may use."""
    if is_deep(d):
        return DEEP_SMEM
    return max(fwd_plan(d)[2], bwd_plan(d, False)[2], bwd_plan(d, True)[2])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as ``c_void_p``, ints as ``c_int``, the cap as ``c_float``)."""
    lib = _build.load("linear_ce")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.linear_ce_splits.argtypes = [i] * 5 + [f]
    lib.linear_ce_fwd_launch.argtypes = [p] * 6 + [i] * 5 + [f, i, p]
    lib.linear_ce_dx_launch.argtypes = [p] * 7 + [i] * 5 + [f, i, p]
    lib.linear_ce_dw_launch.argtypes = [p] * 6 + [i] * 4 + [f, i, p]
    lib.linear_ce_split_launch.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.linear_ce_fwd_plan.argtypes = [i] + [ctypes.POINTER(i)] * 2
    lib.linear_ce_bwd_plan.argtypes = [i, i] + [ctypes.POINTER(i)] * 2
    lib.linear_ce_fwd_deep_launch.argtypes = [p] * 7 + [i] * 5 + [f, i, p]
    lib.linear_ce_bwd_deep_launch.argtypes = [p] * 9 + [i] * 5 + [f, i, p]
    L = ctypes.c_long
    lib.deep_tc_launch.argtypes = [p] * 5 + [i] * 6 + [L] * 5 + [i] * 7 + [p]
    for fn in (lib.linear_ce_splits, lib.linear_ce_fwd_plan,
               lib.linear_ce_bwd_plan,
               lib.linear_ce_fwd_launch,
               lib.linear_ce_dx_launch, lib.linear_ce_dw_launch,
               lib.linear_ce_split_launch, lib.linear_ce_fwd_deep_launch,
               lib.linear_ce_bwd_deep_launch, lib.deep_tc_launch):
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
    operand_dtype("linear_ce", x, w)
    if any(t.dtype != torch.float32 for t in rows):
        raise TypeError("linear_ce takes float32 lse and g")
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
    if d == 0:
        raise ValueError("linear_ce needs d > 0")
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


def _fwd(x, w, targets, logit_softcap, planes=None):
    """``(loss or None, lse)`` from the planes of ``x`` and ``w`` (split
    here when None): with ``targets`` the plucked loss too."""
    shape = _check(x, w, targets)
    n = shape[0]
    cap = _cap(logit_softcap)
    pluck = targets is not None
    if is_deep(shape[2]):
        return _fwd_deep(x, w, targets, cap, shape)
    xp, wp = _planes(x, w, planes)
    s = _splits(0, *shape, pluck, cap, x.device)
    part = torch.empty((s, n, 3), dtype=torch.float32, device=x.device)
    lse = torch.empty((n,), dtype=torch.float32, device=x.device)
    loss = torch.empty_like(lse) if pluck else None
    _call("linear_ce_fwd_launch",
          (xp.data_ptr(), wp.data_ptr(), _ptr(targets), part.data_ptr(),
           _ptr(loss), lse.data_ptr(), *shape, s, int(pluck), cap,
           bf16_flag(x.dtype)), shape, x.device)
    return loss, lse


def _slab(shape, dtype, device):
    """A deep call's ``(N, chunk)`` f32 logits slab and its chunk."""
    n, c, _ = shape
    chunk = deep_chunk(n, c, dtype)
    return torch.empty((n, chunk), dtype=torch.float32, device=device), chunk


def _cotangent_slab(n, chunk, dtype, device):
    """The deep backward's bf16 cotangent for bf16 operands, ``(N,
    chunk)`` at a row pitch of ``chunk`` rounded up to 8 (rows 16-byte
    aligned, as the bf16 product's TMA takes them); None for f32, whose
    cotangent overwrites the logits slab."""
    if dtype != torch.bfloat16:
        return None
    return torch.empty((n, -(-chunk // 8) * 8), dtype=dtype, device=device)


def _fwd_deep(x, w, targets, cap, shape):
    """The deep forward: ``(loss or None, lse)``, one launch."""
    n = shape[0]
    slab, chunk = _slab(shape, x.dtype, x.device)
    state = torch.empty((n, 3), dtype=torch.float32, device=x.device)
    lse = torch.empty((n,), dtype=torch.float32, device=x.device)
    loss = torch.empty_like(lse) if targets is not None else None
    _call("linear_ce_fwd_deep_launch",
          (x.data_ptr(), w.data_ptr(), _ptr(targets), slab.data_ptr(),
           state.data_ptr(), _ptr(loss), lse.data_ptr(), *shape, chunk,
           int(targets is not None), cap, bf16_flag(x.dtype)), shape,
          x.device)
    return loss, lse


def _bwd_deep(x, w, targets, lse, g, logit_softcap, want_dx, want_dw):
    """The deep backward: ``(dx, dw)``, each None unless wanted, one
    launch that writes each chunk's cotangent once for both; in ``x``'s
    and ``w``'s types."""
    lse, g = f32_rows(lse, g)
    shape = _check(x, w, targets, lse, g)
    slab, chunk = _slab(shape, x.dtype, x.device)
    dx, dw = f32_like(x, want_dx), f32_like(w, want_dw)
    _call("linear_ce_bwd_deep_launch",
          (x.data_ptr(), w.data_ptr(), _ptr(targets), lse.data_ptr(),
           g.data_ptr(), _ptr(dx), _ptr(dw), slab.data_ptr(),
           _ptr(_cotangent_slab(shape[0], chunk, x.dtype, x.device)),
           *shape, chunk, int(targets is not None), _cap(logit_softcap),
           bf16_flag(x.dtype)), shape, x.device)
    return (None if dx is None else dx.to(x.dtype),
            None if dw is None else dw.to(w.dtype))


def _split(x, w):
    """The (hi, lo) planes of ``x`` and ``w``: ``(N, dp / 8, 2, 8)``,
    ``(C, dp / 8, 2, 8)`` f32, one launch (bf16 rows: lo 0)."""
    shape = _check(x, w, None)
    n, c, d = shape
    if is_deep(d):
        raise ValueError(f"d={d} > {MAX_D}: the deep variant reads x and w "
                         f"unsplit")
    blocks = padded_depth(d) // 8
    xp = torch.empty((n, blocks, 2, 8), dtype=torch.float32, device=x.device)
    wp = torch.empty((c, blocks, 2, 8), dtype=torch.float32, device=x.device)
    _call("linear_ce_split_launch",
          (x.data_ptr(), w.data_ptr(), xp.data_ptr(), wp.data_ptr(), *shape,
           bf16_flag(x.dtype)), shape, x.device)
    return xp, wp


def _planes(x, w, planes):
    """``planes`` checked against ``x`` and ``w``, or split now."""
    if planes is None:
        return linear_ce_split(x, w)
    xp, wp = planes
    blocks = padded_depth(x.shape[1]) // 8
    for name, p, rows in (("x", xp, x.shape[0]), ("w", wp, w.shape[0])):
        if (p.shape != (rows, blocks, 2, 8) or p.dtype != torch.float32
                or p.device != x.device or not p.is_contiguous()
                or p.data_ptr() % 16):
            raise ValueError(f"planes of {name} must be contiguous, "
                             f"16-byte aligned f32 ({rows}, {blocks}, 2, 8) "
                             f"on {x.device}; got "
                             f"{tuple(p.shape)} {p.dtype} on {p.device}")
    return xp, wp


def _dx(x, w, targets, lse, g, logit_softcap, planes=None):
    if is_deep(x.shape[-1]):
        return _bwd_deep(x, w, targets, lse, g, logit_softcap, True, False)[0]
    lse, g = f32_rows(lse, g)
    shape = _check(x, w, targets, lse, g)
    n, _, d = shape
    cap = _cap(logit_softcap)
    pluck = targets is not None
    xp, wp = _planes(x, w, planes)
    s = _splits(1, *shape, pluck, cap, x.device)
    part = (torch.empty((s, n, d), dtype=torch.float32, device=x.device)
            if s > 1 else None)
    dx = f32_like(x)
    _call("linear_ce_dx_launch",
          (xp.data_ptr(), wp.data_ptr(), _ptr(targets), lse.data_ptr(),
           g.data_ptr(), _ptr(part), dx.data_ptr(), *shape, s, int(pluck),
           cap, bf16_flag(x.dtype)), shape, x.device)
    return dx.to(x.dtype)


def _dw(x, w, targets, lse, g, logit_softcap, planes=None):
    if is_deep(x.shape[-1]):
        return _bwd_deep(x, w, targets, lse, g, logit_softcap, False, True)[1]
    lse, g = f32_rows(lse, g)
    shape = _check(x, w, targets, lse, g)
    cap = _cap(logit_softcap)
    xp, wp = _planes(x, w, planes)
    dw = f32_like(w)
    _call("linear_ce_dw_launch",
          (xp.data_ptr(), wp.data_ptr(), _ptr(targets), lse.data_ptr(),
           g.data_ptr(), dw.data_ptr(), *shape, int(targets is not None),
           cap, bf16_flag(x.dtype)), shape, x.device)
    return dw.to(w.dtype)


def linear_ce_fwd(x, w, targets, *, logit_softcap=None, planes=None):
    """Forward kernel: ``(loss, lse)``, each (N,) f32 (the autograd entry
    returns the loss in ``x``'s type); ``loss = lse −`` the
    target's capped logit (a target outside ``[0, C)`` plucks 0, so its
    loss is exactly its lse — the contract of ``ops.linear_ce_loss``, which
    the plain version keeps too). Matches
    ``ref.linear_ce_loss_ref``. ``planes``: :func:`linear_ce_split`'s
    output for these ``x`` and ``w`` (split here when None)."""
    loss, lse = _fwd(x, w, targets, logit_softcap, planes)
    linear_ce_fwd.launches += 1
    return loss, lse


def linear_ce_split(x, w):
    """Split kernel: ``(xp, wp)``, the (hi, lo) TF32 planes of ``x`` and
    ``w`` that the forward, dX and dW read. Matches
    ``ref.tf32x3_planes_ref`` bit for bit."""
    planes = _split(x, w)
    linear_ce_split.launches += 1
    return planes


def linear_ce_dx(x, w, targets, lse, g, *, logit_softcap=None, planes=None):
    """dX kernel: the (N, d) gradient of ``x`` for the upstream cotangent
    ``g`` (N,) of the loss. ``planes``: :func:`linear_ce_split`'s output
    for these ``x`` and ``w`` (split here when None)."""
    dx = _dx(x, w, targets, lse, g, logit_softcap, planes)
    linear_ce_dx.launches += 1
    return dx


def linear_ce_dw(x, w, targets, lse, g, *, logit_softcap=None, planes=None):
    """dW kernel: the (C, d) gradient of ``w``, each row written once."""
    dw = _dw(x, w, targets, lse, g, logit_softcap, planes)
    linear_ce_dw.launches += 1
    return dw


def deep_tc_product(a, b, *, a_km=False, b_kn=False, idx=None, out=None,
                    m_zero=None):
    """The deep variants' product (``csrc/deep_tc.cuh``) on its own, for
    tests and probes: ``C[t] = A[t] · B[t]ᵀ`` over a batch, f32 out.
    ``a`` and ``b`` f32: 3xTF32; both bfloat16: the bf16 product
    (``gemm_bf16``, every option).
    ``a`` (T, M, K), or (T, K, M) with ``a_km``; ``b`` (T, N, K), or
    (T, K, N) with ``b_kn`` — or, with ``idx`` (T, N) (with ``b_kn``
    (T, K)) int32, a table (R, K) (``b_kn``: (R, N)) whose rows
    ``clamp(idx, 0, R − 1)`` are B's rows. ``m_zero`` (T, M) int32: rows
    with a negative entry come out 0. ``out`` (T, M, N) given: the
    accumulate epilogue, ``out += C`` in place. Returns the (T, M, N)
    output. Matches ``ref.deep_tc_ref``."""
    t = a.shape[0]
    m, k = (a.shape[2], a.shape[1]) if a_km else (a.shape[1], a.shape[2])
    if idx is None:
        n = b.shape[1] if not b_kn else b.shape[2]
    else:
        n = idx.shape[1] if not b_kn else b.shape[1]
    tensors = [x for x in (a, b, idx, out, m_zero) if x is not None]
    if not all(x.is_cuda and x.is_contiguous() for x in tensors):
        raise ValueError("deep_tc_product takes contiguous CUDA tensors")
    acc = out is not None
    if out is None:
        out = torch.empty((t, m, n), dtype=torch.float32, device=a.device)
    if out.shape != (t, m, n):
        raise ValueError(f"out must be {(t, m, n)}")
    with torch.cuda.device(a.device):
        err = _lib().deep_tc_launch(
            a.data_ptr(), b.data_ptr(), _ptr(idx), _ptr(m_zero),
            out.data_ptr(), m, n, k, a.shape[-1], b.shape[-1], n,
            a[0].numel(), 0 if idx is not None else b[0].numel(),
            0 if idx is None else idx.shape[1], m * n, m, b.shape[0], t,
            int(a_km), int(b_kn), int(idx is not None), int(acc),
            bf16_flag(operand_dtype("deep_tc_product", a, b)),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"deep_tc_launch failed: cudaError {err} "
                           f"(M={m}, N={n}, K={k}, batch {t})")
    deep_tc_product.launches += 1
    return out


deep_tc_product.launches = 0
linear_ce_fwd.launches = 0
linear_ce_split.launches = 0
linear_ce_dx.launches = 0
linear_ce_dw.launches = 0


class LinearCELoss(torch.autograd.Function):
    """``loss (N,)`` of ``(x, w, targets, logit_softcap)``; gradients for
    ``x`` and ``w`` (the targets get none)."""

    @staticmethod
    def forward(ctx, x, w, targets, logit_softcap):
        planes = () if is_deep(x.shape[-1]) else linear_ce_split(x, w)
        loss, lse = linear_ce_fwd(x, w, targets, logit_softcap=logit_softcap,
                                  planes=planes or None)
        ctx.save_for_backward(x, w, targets, lse, *planes)
        ctx.logit_softcap = logit_softcap
        return loss.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse, *planes = ctx.saved_tensors
        g = g.contiguous()
        cap = ctx.logit_softcap
        need = ctx.needs_input_grad
        if is_deep(x.shape[-1]):  # one launch, each chunk's G written once
            dx, dw = _bwd_deep(x, w, targets, lse, g, cap, need[0], need[1])
            linear_ce_dx.launches += need[0]
            linear_ce_dw.launches += need[1]
            return dx, dw, None, None
        dx = (linear_ce_dx(x, w, targets, lse, g, logit_softcap=cap,
                           planes=planes) if need[0] else None)
        dw = (linear_ce_dw(x, w, targets, lse, g, logit_softcap=cap,
                           planes=planes) if need[1] else None)
        return dx, dw, None, None


def linear_ce_loss(x, w, targets, *, logit_softcap=None):
    """Per-position full-catalog CE (N,) on the card from hidden states
    ``x`` (N, d) and the table ``w`` (C, d), differentiable in both; the
    ``(N, C)`` logits never exist, forward or backward. See the module
    docstring."""
    return LinearCELoss.apply(x.contiguous(), w.contiguous(),
                              targets.to(torch.int32).contiguous(),
                              logit_softcap)
