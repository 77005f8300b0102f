"""The leave-one-out evaluation sweep on the H100 — the wrapper of
``csrc/eval_fused.cu`` (port of ``repro/kernels/eval_fused.py``).

:func:`eval_fused` checks its inputs, plans the catalog split with
``mips_topk.sweep_plan`` (the tensor-core sweep it shares with
``mips_topk``), allocates the outputs, the per-split scratch and the
rows' shared threshold, and launches the sweep and its merge on
PyTorch's current stream; :func:`eval_tgt_gather` launches the
target-score kernel, whose arithmetic is the sweep's. Both take CUDA
tensors only: the CPU path is ``kernels/ref.py`` (``eval_fused_ref``,
``eval_tgt_gather_ref``), chosen by ``kernels/ops.py``.
``eval_fused.launches`` and ``eval_tgt_gather.launches`` count the calls
that launched each kernel.

Above ``MAX_D`` (``deep.is_deep``) the rows go in slabs
(``mips_topk.slab_rows``) through ``eval_fused_deep_launch``, which first
writes the slab's scores (``csrc/deep_tc.cuh``: 3xTF32 on f32 operands,
``gemm_bf16`` on bf16, never cut in depth) and then sweeps them;
:func:`eval_tgt_gather` takes any depth, by the same arithmetic (on deep
bf16 an ``mma.sync`` bf16 chain that gives ``gemm_bf16``'s bits), so
its score is the slab's column bit for bit.

``x`` and ``y`` are float32 or both bfloat16 (``deep.operand_dtype``).
Resident, bf16 operands are widened to f32 inside the kernels where they
land: every output (f32 scores and LSE pair, int32 ids and counts)
equals the f32 launch's on the widened inputs bit for bit. Deep, the
scores are the bf16 product's: other bits than the f32 launch, within
f32 rounding of the f64 product, repeating bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.deep import (MAX_D, SHALLOW_MAX_K, bf16_flag,
                                      operand_dtype)
from repro_torch.kernels.mips_topk import (SWEEP_WM, n_sm, on_device,
                                          slab_ld, slab_rows, sweep_plan)

INT32_MAX = 2**31 - 1


def _check(x, y, targets, k=None, tgt_scores=None, id_offset=0):
    name = "eval_tgt_gather" if k is None else "eval_fused"
    tensors = [x, y, targets] + ([tgt_scores] if tgt_scores is not None
                                 else [])
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} kernel takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"{name}: tensors on {[str(t.device) for t in tensors]}")
    operand_dtype(name, x, y)
    if targets.dtype != torch.int32:
        raise ValueError(f"{name} takes int32 targets, got {targets.dtype}")
    n = x.shape[0] if x.ndim == 2 else -1
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1] \
            or targets.shape != (n,):
        raise ValueError(f"need x (n, d), y (C, d), targets (n,); got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(targets.shape)}")
    if tgt_scores is not None and (tgt_scores.shape != (n,)
                                   or tgt_scores.dtype != torch.float32):
        raise ValueError(f"tgt_scores must be ({n},) float32, got "
                         f"{tuple(tgt_scores.shape)} {tgt_scores.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if not x.shape[1] > 0:
        raise ValueError(f"{name} needs d > 0")
    if y.shape[0] == 0:
        raise ValueError(f"{name} needs a catalog of at least one row")
    if k is not None and not 0 < k <= SHALLOW_MAX_K:
        raise ValueError(f"k={k} outside (0, {SHALLOW_MAX_K}]")
    if not 0 <= id_offset <= INT32_MAX - (y.shape[0] + 64):
        raise ValueError(f"id_offset={id_offset} overflows int32 ids")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as ``c_void_p``, ints as ``c_int``, the cap as ``c_float``)."""
    lib = _build.load("eval_fused")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.eval_tgt_gather_launch.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.eval_tgt_gather_launch.restype = ctypes.c_int
    lib.eval_fused_launch.argtypes = [p] * 16 + [i] * 11 + [f, i, i, p]
    lib.eval_fused_launch.restype = ctypes.c_int
    lib.eval_fused_deep_launch.argtypes = [p] * 17 + [i] * 11 + [f, i, i, p]
    lib.eval_fused_deep_launch.restype = ctypes.c_int
    lib.eval_score_slab_launch.argtypes = [p] * 3 + [i] * 4 + [p]
    lib.eval_score_slab_launch.restype = ctypes.c_int
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def eval_tgt_gather(x, y, targets, *, id_offset: int = 0):
    """Each row's target score ``x[r] · y[targets[r] − id_offset]`` on
    the card, by the very 3xTF32 ``mma`` sequence (orientation, split, k
    order) the :func:`eval_fused` sweep runs — on deep bf16 operands the
    ``mma.sync`` bf16 chain that gives the score slab's bits — so it
    equals the swept target column bit for bit; 0 where the target is
    outside ``[id_offset, id_offset + C)``.

    x : (n, d) float32 or bfloat16, y : (C, d) of x's dtype, targets :
    (n,) int32; all contiguous CUDA tensors. → (n,) float32.
    """
    _check(x, y, targets, id_offset=id_offset)
    n, d = x.shape
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _lib()
    with on_device(x.device):
        err = lib.eval_tgt_gather_launch(
            x.data_ptr(), y.data_ptr(), targets.data_ptr(), out.data_ptr(),
            n, y.shape[0], d, id_offset, bf16_flag(x.dtype),
            _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"eval_tgt_gather launch failed: cudaError {err} "
                           f"(n={n}, C={y.shape[0]}, d={d})")
    eval_tgt_gather.launches += 1
    return out


def score_slab(x, y):
    """The deep variant's score slab alone, ``S (C, n)`` f32 with
    ``S[c, r] = y[c] · x[r]``, as ``eval_fused_deep_launch`` writes it
    before its sweep (the same library code): for the tests and probes
    that hold a target score against its slab column. x (n, d), y (C, d),
    float32 or both bfloat16, contiguous CUDA tensors, d > ``MAX_D``."""
    _check(x, y, torch.zeros(x.shape[0], dtype=torch.int32,
                             device=x.device))
    n, d = x.shape
    c = y.shape[0]
    if d <= MAX_D:
        raise ValueError(f"score_slab is the deep variant's: d {d} <= "
                         f"{MAX_D}")
    out = torch.empty((c, n), dtype=torch.float32, device=x.device)
    with on_device(x.device):
        err = _lib().eval_score_slab_launch(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), n, c, d,
            bf16_flag(x.dtype), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"eval_score_slab launch failed: cudaError {err} "
                           f"(n={n}, C={c}, d={d})")
    return out


def eval_fused(x, y, targets, k: int, *, tgt_scores=None, c_lo: int = 0,
               c_hi=None, id_offset: int = 0, logit_softcap=None,
               with_lse: bool = False):
    """One catalog sweep on the card: per-row top-``k``, the target's
    rank counts and, with ``with_lse``, the online LSE of the softcapped
    logits, without the ``(n, C)`` score matrix.

    Parameters
    ----------
    x : (n, d) float32 or bfloat16 user states, any d > 0 (above
        ``MAX_D`` the deep variant); y : (C, d) catalog rows of x's
        dtype (or
        a shard whose first row has global id ``id_offset``); targets :
        (n,) int32 global target ids. All contiguous CUDA tensors.
    k : list length, 1..512; may exceed the valid columns (the tail is
        ``(NEG_INF, ID_PAD)``).
    tgt_scores : optional (n,) float32 threshold; default
        :func:`eval_tgt_gather` over this ``y``.
    c_lo, c_hi : global-id window of the valid columns (default
        ``[0, id_offset + C)``).
    logit_softcap : cap of the LSE's logits (ranks keep raw scores).

    Returns
    -------
    ``(vals, ids, gt, eq, tgt, m, s)`` as ``ref.eval_fused_ref``: vals
    (n, k) f32 and ids (n, k) int32, gt and eq (n,) int32, tgt the (n,)
    threshold compared against, m and s the (n,) f32 LSE pair
    (``lse = m + log s``) or ``None`` without ``with_lse``.
    """
    _check(x, y, targets, k, tgt_scores, id_offset)
    n, d = x.shape
    c = y.shape[0]
    if c_hi is None:
        c_hi = id_offset + c
    c_lo = max(min(c_lo, INT32_MAX), -INT32_MAX)
    c_hi = max(min(c_hi, INT32_MAX), -INT32_MAX)
    dev = x.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    vals, ids = empty(n, k), empty(n, k, dtype=torch.int32)
    gt, eq = empty(n, dtype=torch.int32), empty(n, dtype=torch.int32)
    m = empty(n) if with_lse else None
    s = empty(n) if with_lse else None
    if n == 0:
        return vals, ids, gt, eq, empty(0), m, s
    if tgt_scores is None:
        tgt_scores = eval_tgt_gather(x, y, targets, id_offset=id_offset)
    cap = float(logit_softcap) if logit_softcap is not None else 0.0
    outs = (tgt_scores, targets, vals, ids, gt, eq, m, s)
    if d <= MAX_D:
        _launch(x, y, outs, k, id_offset, c_lo, c_hi, cap, with_lse)
    else:
        rows = slab_rows(n, c)
        scores = empty(c * slab_ld(rows))
        for r in range(0, n, rows):
            _launch(x[r:r + rows], y,
                    tuple(t if t is None else t[r:r + rows] for t in outs),
                    k, id_offset, c_lo, c_hi, cap, with_lse, scores)
    eval_fused.launches += 1
    return vals, ids, gt, eq, tgt_scores, m, s


def _launch(x, y, outs, k, id_offset, c_lo, c_hi, cap, with_lse,
            scores=None):
    """One launch of the sweep and its merge for the rows of ``x``:
    ``outs`` = (tgt_scores, targets, vals, ids, gt, eq, m, s) of those rows;
    with ``scores`` (``C·n`` f32) the deep variant on that workspace."""
    n, d = x.shape
    c = y.shape[0]
    dev = x.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    pl = sweep_plan(n, c, d, k, n_sm(dev))
    part_vals = empty(n, pl.n_split, k)
    part_ids = empty(n, pl.n_split, k, dtype=torch.int32)
    part_cnt = empty(n, pl.n_split, 2, dtype=torch.int32)
    part_ms = empty(n, pl.n_split, 2) if with_lse else None
    tau = empty(n, dtype=torch.int32)
    uv = empty(n, pl.pre_split * 8 * SWEEP_WM[pl.query_tiles]) \
        if pl.pre_split else None
    tgt_scores, targets, vals, ids, gt, eq, m, s = outs
    lib = _lib()
    entry, tail = lib.eval_fused_launch, ()
    if scores is not None:
        entry, tail = lib.eval_fused_deep_launch, (scores,)
    with on_device(dev):
        err = entry(
            *(t.data_ptr() if t is not None else None for t in (
                x, y, tgt_scores, targets, part_vals, part_ids, part_cnt,
                part_ms, tau, uv, vals, ids, gt, eq, m, s) + tail),
            n, c, d, k, pl.query_tiles, pl.n_split, pl.pre_split,
            pl.pre_period, id_offset, c_lo, c_hi, cap, int(with_lse),
            bf16_flag(x.dtype), _stream(dev),
        )
    if err != 0:
        raise RuntimeError(
            f"eval_fused launch failed: cudaError {err} (n={n}, C={c}, d={d}, "
            f"k={k}, plan={pl})"
        )


eval_fused.launches = 0
eval_tgt_gather.launches = 0
