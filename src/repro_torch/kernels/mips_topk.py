"""Per-row MIPS top-k on the H100 — the wrapper of
``csrc/mips_topk.cu`` (port of ``repro/kernels/mips_topk.py``).

It checks its inputs, plans the catalog split, allocates the outputs
and the ``(n_q, S, k)`` candidate scratch, and launches the kernel pair
on PyTorch's current stream. It takes CUDA tensors only: the CPU path is
``kernels/ref.py::mips_topk_ref``, chosen by ``kernels/ops.py``.
``mips_topk.launches`` counts the calls that launched the kernel, and
``mips_topk.launches_by_k`` counts them by ``k``.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

TILE_C = 64  # catalog rows per tile (kTileC in the source)
MAX_K = 512  # kMaxK in the source (lists of ≤ 256 and ≤ 512 entries)
MAX_D = 256
MAX_SMEM = 232448  # bytes of shared memory one block may opt in to on sm_90
SMALL_K = 32  # k up to this may take blocks of 32 or 64 query rows


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call cuts its work: ``rows_per_thread`` (RM) sets the
    block's ``16·RM`` query rows; the catalog goes in ``n_split``
    contiguous splits of ``split_cols`` rows (a whole number of tiles)."""

    rows_per_thread: int
    n_split: int
    split_cols: int


def partial_smem_bytes(rows_per_thread: int, d: int, k: int) -> int:
    """Shared memory of one partial block, as ``partial_smem_bytes`` in
    the source lays it out (the source refuses a launch above
    ``MAX_SMEM``, so a plan that disagreed would raise): staged queries
    and two catalog tiles at a row pitch of an odd number of float4s,
    the tiles' valid flags, per-row candidate counts, per-row candidate
    buffers and the per-row (value, id) lists."""
    qb = 16 * rows_per_thread
    pitch = 4 * ((-(-d // 4)) | 1)
    return 4 * (qb * pitch + 2 * TILE_C * pitch) + 4 * (2 * TILE_C + qb) \
        + 8 * qb * (TILE_C + k)


def merge_smem_bytes(k: int) -> int:
    """Shared memory of one merge block, as ``merge_smem_bytes`` in the
    source: a k-entry list and a 32-slot buffer per warp of 8."""
    return 8 * 8 * (k + 32)


def planned_smem(n_q: int, c: int, d: int, k: int, n_sm: int) -> int:
    """Dynamic shared memory per block of the larger of the two launches
    of one call (the partial pass at :func:`plan`'s block height, the
    merge), which ``eval_fused``'s and ``eval_topk``'s sweeps share. The
    kernel guard checks it against the 227 KB a block may use."""
    p = plan(n_q, c, d, k, n_sm)
    return max(partial_smem_bytes(p.rows_per_thread, d, k),
               merge_smem_bytes(k))


@functools.lru_cache(maxsize=256)
def plan(n_q: int, c: int, d: int, k: int, n_sm: int) -> Plan:
    """Pick the block height and the catalog split for one call.

    Block height: for ``k ≤ SMALL_K`` (serving) the smallest block that
    holds the bucket's rows (16, 32 or 64), shrunk while its shared
    memory would not fit; above it (SCE training's selections) 16 rows,
    the fastest height at every split count there.
    Splits: as many as keep all blocks in one wave of ``2·n_sm``, at
    least one. At k 256 and 320 two 16-row blocks fit an SM (shared
    memory and registers); shorter splits then run faster until the
    blocks spill a mostly empty second wave, which costs a whole block's
    time. ``probes/mips_topk_times.py sweep`` on the H100 read 13 splits
    (260 blocks) fastest and 14 (280) slowest of the counts it tried at
    both training selections (PERF.md §6). At serving's buckets
    ``2·n_sm`` divides exactly."""
    tiles = -(-c // TILE_C)
    rm = 1 if n_q <= 16 or k > SMALL_K else 2 if n_q <= 32 else 4
    while rm > 1 and partial_smem_bytes(rm, d, k) > MAX_SMEM:
        rm //= 2
    n_qb = -(-n_q // (16 * rm))
    n_split = min(tiles, max(1, 2 * n_sm // n_qb))
    split_cols = -(-tiles // n_split) * TILE_C
    return Plan(rm, -(-c // split_cols), split_cols)


def _check(q, y, valid, k, id_offset):
    if not (q.is_cuda and y.is_cuda):
        raise ValueError("mips_topk kernel takes CUDA tensors only")
    if q.device != y.device:
        raise ValueError(f"q on {q.device} but y on {y.device}")
    if q.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"mips_topk takes float32, got {q.dtype}, {y.dtype}")
    if q.ndim != 2 or y.ndim != 2 or q.shape[1] != y.shape[1]:
        raise ValueError(f"need q (n_q, d), y (C, d); got {q.shape}, {y.shape}")
    if not (q.is_contiguous() and y.is_contiguous()):
        raise ValueError("mips_topk takes contiguous q and y")
    d = q.shape[1]
    if not 0 < d <= MAX_D:
        raise ValueError(f"d={d} outside (0, {MAX_D}]")
    if not 0 < k <= MAX_K:
        raise ValueError(f"k={k} outside (0, {MAX_K}]")
    if not 0 <= id_offset <= 2**31 - 1 - (y.shape[0] + TILE_C):
        raise ValueError(f"id_offset={id_offset} overflows int32 ids")
    if valid is not None:
        if valid.shape != (y.shape[0],) or valid.device != y.device:
            raise ValueError(
                f"valid must be ({y.shape[0]},) on {y.device}, got "
                f"{tuple(valid.shape)} on {valid.device}"
            )
        if valid.dtype != torch.bool or not valid.is_contiguous():
            raise TypeError(
                f"valid must be a contiguous bool mask, got {valid.dtype}"
            )


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as ``c_void_p``, ints as ``c_int``)."""
    lib = _build.load("mips_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mips_topk_launch.argtypes = [p, p, p, p, p, p, p] + [i] * 8 + [p]
    lib.mips_topk_launch.restype = ctypes.c_int
    return lib


def mips_topk(q, y, k: int, *, valid=None, id_offset: int = 0):
    """Per-row top-``k`` of ``q @ yᵀ`` on the card, without the
    ``(n_q, C)`` score matrix.

    Parameters
    ----------
    q : (n_q, d) float32 CUDA tensor, contiguous.
    y : (C, d) float32 CUDA tensor, contiguous (catalog, or a shard).
    k : top-k size, clamped to ``C``; at most 512 after the clamp.
    valid : optional (C,) contiguous bool — rows with False are never
        selected.
    id_offset : global id of ``y``'s first row.

    Returns
    -------
    (vals (n_q, k) float32, ids (n_q, k) int32): values descending, ties
    to the lower id, ``ID_PAD`` where fewer than ``k`` rows are valid —
    the contract of ``ref.mips_topk_ref``.
    """
    c = y.shape[0]
    k = min(k, c)
    _check(q, y, valid, k, id_offset)
    n_q, d = q.shape
    vals = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    ids = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    if n_q == 0:
        return vals, ids
    lib = _lib()
    props = torch.cuda.get_device_properties(q.device)
    p = plan(n_q, c, d, k, props.multi_processor_count)
    part_vals = torch.empty(
        (n_q, p.n_split, k), dtype=torch.float32, device=q.device
    )
    part_ids = torch.empty((n_q, p.n_split, k), dtype=torch.int32,
                           device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mips_topk_launch(
            q.data_ptr(), y.data_ptr(),
            valid.data_ptr() if valid is not None else None,
            part_vals.data_ptr(), part_ids.data_ptr(),
            vals.data_ptr(), ids.data_ptr(),
            n_q, c, d, k, p.rows_per_thread, p.n_split, p.split_cols,
            id_offset, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"mips_topk launch failed: cudaError {err} "
            f"(n_q={n_q}, C={c}, d={d}, k={k}, plan={p})"
        )
    mips_topk.launches += 1
    mips_topk.launches_by_k[k] += 1
    return vals, ids


mips_topk.launches = 0
mips_topk.launches_by_k = collections.Counter()
