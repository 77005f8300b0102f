"""Per-row MIPS top-k on the H100 — the wrapper of
``csrc/mips_topk.cu`` (port of ``repro/kernels/mips_topk.py``).

It checks its inputs, plans the work, allocates the outputs and the
scratch, and launches on PyTorch's current stream: for ``k ≤ SMALL_K``
(serving) the tensor-core sweep with its shared threshold and the merge
(:func:`sweep_plan`, ``(n_q, S, k)`` candidate lists; ``eval_fused`` and
``eval_topk`` run the same sweep at every k); above it (SCE training's
selections) the threshold, collect and select chain
(:func:`select_plan`), whose rows that collect more than ``kcap``
entries the f32 FMA split sweep finishes (:func:`plan`). It takes CUDA
tensors only: the CPU path is ``kernels/ref.py::mips_topk_ref``, chosen
by ``kernels/ops.py``. ``mips_topk.launches`` counts the calls that
launched the kernel, and ``mips_topk.launches_by_k`` counts them by
``k``; ``mips_topk.last_counts`` holds the last ``k > SMALL_K`` call's
per-row collect counts (a device tensor: a count above its ``kcap`` is
a row the split sweep finished).

Deep variants (:func:`is_deep`): where the resident kernels cannot take
the shape — ``d > MAX_D``, or in the chain ``k > SHALLOW_MAX_K`` — the
wrapper cuts the queries into slabs (:func:`slab_rows`) and, per slab,
the source's ``*_deep_launch`` entries first write the score slab
``S = Y · Qᵀ`` (``csrc/deep_tc.cuh``: f32 in 3xTF32 on ``wgmma`` over
depth chunks of 32; bf16 on ``gemm_bf16``, bf16 ``wgmma``) into a
workspace, then run the same sweep or chain on it. Below those limits
the resident kernels run as before.

``q`` and ``y`` are float32 or both bfloat16 (``deep.operand_dtype``).
Resident, bf16 operands are widened to f32 inside the kernels as they
are staged, so the outputs (f32 values, int32 ids) equal the f32
launch's on the widened inputs bit for bit. Deep, they score on the bf16
product: other bits than the f32 launch, within f32 rounding of the f64
product, repeating bit for bit. Each score is one product over the whole
depth, so a query's outputs do not depend on the other queries of its
call.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.deep import (MAX_D, SHALLOW_MAX_K, bf16_flag,
                                      is_deep, operand_dtype, slab_rows)

TILE_C = 64  # catalog rows per tile (kTileC, kTile in the sources)
MAX_K = 1024  # kMaxK: the deep k > 32 chain's lists
MAX_SMEM = 232448  # bytes of shared memory one block may opt in to on sm_90
SM_SMEM = 233472  # bytes of shared memory of one SM (1 KB of it per block)
SMALL_K = 32  # k up to this takes the tensor-core sweep
QUERY_TILES = (1, 4, 16)  # n8 query tiles a sweep block may hold (Cfg)
SWEEP_WM = {1: 4, 4: 4, 16: 2}  # Cfg::kWM: warps across a tile's rows
SWEEP_CAP = TILE_C + 32  # kCap: candidate slots a row of a sweep block
SLAB_QUERY_TILES = (1, 4)  # n8 query tiles a deep (FROM_S) sweep block holds
SLAB_STAGES = 3  # kSlabStages: the deep sweep's ring of slab tiles
SLAB_MIN_BLOCKS = 4  # sweep_min_blocks<NQT, true>: its blocks an SM
MERGE_CAP = 1024  # kMergeCap: entries a sweep's merge block gathers
PRE_SAMPLE = 8  # the pre-pass reads one tile in PRE_SAMPLE
PRE_UNION = 8192  # most pre-pass entries a row's τ selection holds
PASS_ROWS = 64  # query rows of a threshold / collect block (kPassQB)
UNION_PER_SPLIT = 16  # union entries per row and split (a thread's best)
MAX_SORT = 8192  # kMaxSort: entries one row's sort may hold
MAX_SAMPLE = 4  # the threshold pass reads at least 1/MAX_SAMPLE of the tiles
MAX_UNION_SPLIT = 128  # threshold splits at most (a 2,048-entry union)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the f32 FMA split sweep that finishes a ``k > SMALL_K`` row
    cuts its work: blocks of 16 query rows; the catalog in ``n_split``
    contiguous splits of ``split_cols`` rows (a whole number of tiles)."""

    n_split: int
    split_cols: int


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """How a tensor-core sweep cuts its work: ``8·query_tiles`` query rows
    a block; the catalog's tiles in ``n_split`` balanced contiguous
    splits (:func:`split_bounds`); with ``pre_split > 0`` a pre-pass
    first, its split ``s`` visiting the tiles ``s, s + pre_period, …`` and
    publishing the shared threshold only."""

    query_tiles: int
    n_split: int
    pre_split: int = 0
    pre_period: int = 0


def split_bounds(c: int, n_split: int, s: int):
    """The catalog rows ``[lo, hi)`` of split ``s`` of a tensor-core sweep,
    as the kernel cuts them: the tiles ``[⌊s·T / S⌋, ⌊(s + 1)·T / S⌋)``
    of the catalog's ``T`` tiles."""
    tiles = -(-c // TILE_C)
    lo = s * tiles // n_split * TILE_C
    return min(lo, c), min((s + 1) * tiles // n_split * TILE_C, c)


def partial_smem_bytes(rows_per_thread: int, d: int, k: int,
                       from_s: bool = False) -> int:
    """Shared memory of one partial block, as ``partial_smem_bytes`` in
    the source lays it out (the source refuses a launch above
    ``MAX_SMEM``, so a plan that disagreed would raise): staged queries
    and two catalog tiles at a row pitch of an odd number of float4s
    (none ``from_s``: the deep variant reads the score slab), the tiles'
    valid flags, per-row candidate counts, per-row candidate buffers and
    the per-row (value, id) lists."""
    qb = 16 * rows_per_thread
    pitch = 0 if from_s else 4 * ((-(-d // 4)) | 1)
    return 4 * (qb * pitch + 2 * TILE_C * pitch) + 4 * (2 * TILE_C + qb) \
        + 8 * qb * (TILE_C + k)


def merge_smem_bytes(k: int) -> int:
    """Shared memory of one merge block, as ``merge_smem_bytes`` in the
    source: a k-entry list and a 32-slot buffer per warp of 8."""
    return 8 * 8 * (k + 32)


def slab_ld(n_q: int) -> int:
    """The deep sweep's score slab row pitch in floats for ``n_q`` query
    columns (``slab_ld`` in ``topk_tile.cuh``): a multiple of 4, as the
    slab's tensor map wants 16-byte rows. The wrappers allocate
    ``C·slab_ld(rows)`` floats for a slab of ``rows`` queries."""
    return -(-n_q // 4) * 4


def sweep_smem_bytes(query_tiles: int, d: int, k: int) -> int:
    """Shared memory of one tensor-core sweep block, as
    ``sweep_smem_bytes`` in ``topk_tile.cuh`` lays it out (the source
    refuses a launch above ``MAX_SMEM``, so a plan that disagreed would
    raise): the queries' B fragments (hi, lo) at the depth rounded up to
    16, two catalog tiles at a pitch ≡ 8 mod 32 floats — above ``MAX_D``
    (the deep variant, which reads the score slab) in their place the
    ring of ``SLAB_STAGES`` slab tiles (64 rows of the block's query
    columns, as the TMA writes a box), 1 KB to align it and its
    mbarriers —, their valid flags, four merge-request words,
    per-row counts, and per row a (value, id) list of ``k`` and a
    candidate buffer of ``SWEEP_CAP``."""
    qb = 8 * query_tiles
    dp = -(-d // 16) * 16
    pitch = -(-dp // 32) * 32 + 8
    stage = (SLAB_STAGES * TILE_C * qb + 256 + 2 * SLAB_STAGES
             if d > MAX_D else 2 * qb * dp + 2 * TILE_C * pitch)
    return 4 * (stage + 2 * TILE_C + 4 + qb + 2 * qb * (k + SWEEP_CAP))


def sweep_merge_smem_bytes(k: int) -> int:
    """Shared memory of one merge block of the tensor-core sweep, as
    ``sweep_merge_smem_bytes`` in the source: the merge's lists and
    buffers and ``MERGE_CAP`` gathered (value, id) entries."""
    return merge_smem_bytes(k) + 8 * MERGE_CAP + 16


def tau_select_smem_bytes(n: int) -> int:
    """Shared memory of one τ selection block, as in the source: the row's
    ``n`` pre-pass entries and 32 a warp."""
    return 4 * (n + 32 * 8)


def sweep_smem(n_q: int, c: int, d: int, k: int, n_sm: int) -> int:
    """Dynamic shared memory per block of the largest of the tensor-core
    sweep's launches (the pre-pass and the sweep at :func:`sweep_plan`'s
    block height, the τ selection, the merge), which ``mips_topk`` at
    ``k ≤ SMALL_K``, ``eval_fused`` and ``eval_topk`` share (a deep call:
    at its slab's rows)."""
    if d > MAX_D:
        n_q = slab_rows(n_q, c)
    p = sweep_plan(n_q, c, d, k, n_sm)
    n_union = p.pre_split * 8 * SWEEP_WM[p.query_tiles]
    return max(sweep_smem_bytes(p.query_tiles, d, k),
               sweep_merge_smem_bytes(k), tau_select_smem_bytes(n_union))


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def sort_smem_bytes(n: int) -> int:
    """Shared memory of one row's sort of ``n`` entries, as
    ``sort_smem_bytes`` in the source: a power of two ≥ 256 entries of
    (value, id), one padding slot per 32."""
    size = max(256, _pow2_at_least(n))
    return 8 * (size + size // 32)


def pass_smem_bytes(d: int, from_s: bool = False) -> int:
    """Shared memory of one threshold or collect block, as
    ``pass_smem_bytes`` in the source: 64 staged query rows and two
    catalog tiles (none ``from_s``), and the tiles' valid flags."""
    pitch = 0 if from_s else 4 * ((-(-d // 4)) | 1)
    return 4 * (PASS_ROWS + 2 * TILE_C) * pitch + 4 * 2 * TILE_C


def select_smem(n_q: int, c: int, d: int, k: int, n_sm: int) -> int:
    """Dynamic shared memory per block of the largest launch of the
    ``k > SMALL_K`` chain, as ``select_smem_bytes`` in the source: the
    passes, the τ and select sorts, and the finishing split sweep at 16
    rows a block (a deep call: at its slab's rows, reading the slab)."""
    deep = is_deep(d, k)
    if deep:
        n_q = slab_rows(n_q, c)
    sp = select_plan(n_q, c, d, k, n_sm)
    return max(pass_smem_bytes(d, deep),
               sort_smem_bytes(max(UNION_PER_SPLIT * sp.n_split, k)),
               sort_smem_bytes(sp.kcap), partial_smem_bytes(1, d, k, deep),
               merge_smem_bytes(k))


def planned_smem(n_q: int, c: int, d: int, k: int, n_sm: int) -> int:
    """Dynamic shared memory per block of the largest launch of one
    ``mips_topk`` call: the split sweep for ``k ≤ SMALL_K``, the select
    chain above. The kernel guard checks it against the 227 KB a block
    may use."""
    if k > SMALL_K:
        return select_smem(n_q, c, d, k, n_sm)
    return sweep_smem(n_q, c, d, k, n_sm)


@functools.lru_cache(maxsize=256)
def plan(n_q: int, c: int, d: int, k: int, n_sm: int) -> Plan:
    """Split the catalog for the f32 FMA sweep that finishes the rows of a
    ``k > SMALL_K`` call whose collect buffer overflowed: blocks of 16
    rows, and as many splits as keep all blocks in one wave of
    ``2·n_sm``, at least one. At k 256 and 320 two 16-row blocks fit an
    SM (shared memory and registers); shorter splits then run faster
    until the blocks spill a mostly empty second wave, which costs a
    whole block's time. ``probes/mips_topk_times.py`` on the H100 read 13
    splits (260 blocks) fastest and 14 (280) slowest of the counts it
    tried at both training selections, when this sweep still ran them
    (PERF.md §6)."""
    tiles = -(-c // TILE_C)
    n_split = min(tiles, max(1, 2 * n_sm // -(-n_q // 16)))
    split_cols = -(-tiles // n_split) * TILE_C
    return Plan(-(-c // split_cols), split_cols)


@functools.lru_cache(maxsize=256)
def sweep_plan(n_q: int, c: int, d: int, k: int, n_sm: int) -> SweepPlan:
    """Pick the block height and the catalog split of one tensor-core
    sweep (``mips_topk`` at ``k ≤ SMALL_K``, ``eval_fused``,
    ``eval_topk``).

    Block height: the fewest query tiles (1, 4 or 16: 8, 32 or 128 rows)
    that hold the call's rows, else the most, among those whose block
    fits ``MAX_SMEM`` (8 rows always do, to k 512 at d 256).
    Splits: as many as give one block to each place an SM has for one —
    as many blocks as shared memory allows, at most 4, 2 and 1 for 1, 4
    and 16 query tiles (the kernels' ``__launch_bounds__``) — rounded up
    over the row blocks (one wave when their count divides it, as at
    every serving and evaluation shape), at most one per tile.
    Pre-pass (k ≤ 32, a catalog of ``16·PRE_SAMPLE`` tiles or more): one
    tile in ``PRE_SAMPLE``, strided over up to ``n_split`` blocks of about
    four tiles each, its union within ``PRE_UNION`` entries a row. On the
    H100 it beat τ by ``atomicMax`` alone, and one tile in 8 beat one in
    4 (``probes/topk_variants.py``, PERF.md §6).
    Above ``MAX_D`` the deep sweep, which reads the score slab, takes its
    own plan (:func:`slab_sweep_plan`)."""
    if d > MAX_D:
        return slab_sweep_plan(n_q, c, k, n_sm)
    fits = [t for t in QUERY_TILES if sweep_smem_bytes(t, d, k) <= MAX_SMEM]
    nqt = next((t for t in fits if 8 * t >= n_q), fits[-1])
    per_sm = min({1: 4, 4: 2, 16: 1}[nqt],
                 SM_SMEM // (sweep_smem_bytes(nqt, d, k) + 1024))
    n_qb = -(-n_q // (8 * nqt))
    tiles = -(-c // TILE_C)
    n_split = min(tiles, -(-per_sm * n_sm // n_qb))
    return SweepPlan(nqt, n_split, *_pre_pass(tiles, n_split, nqt, k))


def _pre_pass(tiles: int, n_split: int, nqt: int, k: int):
    """``(pre_split, pre_period)`` of a sweep's pre-pass (see
    :func:`sweep_plan`)."""
    pre = 0
    if k <= SMALL_K and tiles >= 16 * PRE_SAMPLE:
        pre = min(n_split, tiles // (4 * PRE_SAMPLE),
                  PRE_UNION // (8 * SWEEP_WM[nqt]))
    return pre, pre * PRE_SAMPLE


@functools.lru_cache(maxsize=256)
def slab_sweep_plan(n_q: int, c: int, k: int, n_sm: int) -> SweepPlan:
    """The deep sweep's plan: it reads the ``(C, n_q)`` score slab through
    a ring of TMA boxes and holds neither query fragments nor catalog
    tiles, so its blocks are smaller than the resident ones.

    Block height: 1 query tile where it holds the call's rows, else 4
    (``SLAB_QUERY_TILES``: boxes of 32 columns, 128-byte rows), 4 warps.
    Blocks an SM: as many as shared memory allows, at most
    ``SLAB_MIN_BLOCKS`` (the kernels' ``__launch_bounds__``): 4 at k 1,
    16 warps and 8 tiles of copies in flight an SM.
    Splits: as many as fill that one wave without a second, partial one
    (rounded down over the row blocks), at most one per tile.
    Pre-pass: as :func:`sweep_plan`'s."""
    fits = [t for t in SLAB_QUERY_TILES
            if sweep_smem_bytes(t, MAX_D + 1, k) <= MAX_SMEM]
    nqt = next((t for t in fits if 8 * t >= n_q), fits[-1])
    per_sm = min(SLAB_MIN_BLOCKS,
                 SM_SMEM // (sweep_smem_bytes(nqt, MAX_D + 1, k) + 1024))
    n_qb = -(-n_q // (8 * nqt))
    tiles = -(-c // TILE_C)
    n_split = min(tiles, max(1, per_sm * n_sm // n_qb))
    return SweepPlan(nqt, n_split, *_pre_pass(tiles, n_split, nqt, k))


@dataclasses.dataclass(frozen=True)
class SelectPlan:
    """How a ``k > SMALL_K`` call cuts its work, at 64 query rows a block:
    the threshold pass's ``n_split`` splits, split ``s`` visiting the
    tiles ``s, s + period, …`` (``period = n_split·R``: a 1/R sample of
    the tiles); the collect pass's ``collect_split`` splits, strided the
    same way over every tile; ``kcap`` collect entries per row."""

    n_split: int
    period: int
    collect_split: int
    kcap: int


@functools.lru_cache(maxsize=256)
def select_plan(n_q: int, c: int, d: int, k: int, n_sm: int) -> SelectPlan:
    """Plan the threshold, collect and select chain of one ``k > SMALL_K``
    call.

    Splits: as many as keep the 64-row blocks in one wave of ``2·n_sm``,
    and at least ``k / 16``, so the union (16 entries per row and split)
    can hold k real entries; at most one per tile and
    ``MAX_UNION_SPLIT``, which bounds the union's sort. A union with fewer
    than ``k`` real entries yields no threshold (every valid column is
    collected), which is exact, only slower.
    Sample: the threshold pass reads one tile in R (R ≤ ``MAX_SAMPLE``, a
    power of two) while the sample keeps at least 128·k columns; its τ
    then lies near the R·k-th score. ``kcap = 4·R·k`` (a power of two, at
    most ``MAX_SORT``) leaves room for four times that — all-equal scores
    collect ≈ 4·R·k, as each thread keeps the first of its 4 columns a
    tile —, and costs only memory: the select sorts what a row holds."""
    tiles = -(-c // TILE_C)
    wave = max(1, 2 * n_sm // -(-n_q // PASS_ROWS))
    n_split = min(tiles, MAX_UNION_SPLIT,
                  max(wave, -(-k // UNION_PER_SPLIT)))
    sample = 1
    while (2 * sample <= MAX_SAMPLE and c // (2 * sample) >= 128 * k
           and 2 * sample * n_split <= tiles):
        sample *= 2
    kcap = min(MAX_SORT, _pow2_at_least(4 * sample * k))
    return SelectPlan(n_split, sample * n_split, min(tiles, wave), kcap)


def _check(q, y, valid, k, id_offset, kcap=None):
    if not (q.is_cuda and y.is_cuda):
        raise ValueError("mips_topk kernel takes CUDA tensors only")
    if q.device != y.device:
        raise ValueError(f"q on {q.device} but y on {y.device}")
    operand_dtype("mips_topk", q, y)
    if q.ndim != 2 or y.ndim != 2 or q.shape[1] != y.shape[1]:
        raise ValueError(f"need q (n_q, d), y (C, d); got {q.shape}, {y.shape}")
    if not (q.is_contiguous() and y.is_contiguous()):
        raise ValueError("mips_topk takes contiguous q and y")
    if not q.shape[1] > 0:
        raise ValueError("mips_topk needs d > 0")
    if not 0 < k <= MAX_K:
        raise ValueError(f"k={k} outside (0, {MAX_K}]")
    if kcap is not None and k > SMALL_K and not k <= kcap <= MAX_SORT:
        raise ValueError(f"kcap={kcap} outside [k={k}, {MAX_SORT}]")
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
    lib.mips_topk_launch.argtypes = [p] * 9 + [i] * 10 + [p]
    lib.mips_topk_launch.restype = ctypes.c_int
    lib.mips_topk_select_launch.argtypes = [p] * 14 + [i] * 12 + [p]
    lib.mips_topk_select_launch.restype = ctypes.c_int
    lib.mips_topk_deep_launch.argtypes = [p] * 10 + [i] * 10 + [p]
    lib.mips_topk_deep_launch.restype = ctypes.c_int
    lib.mips_topk_select_deep_launch.argtypes = [p] * 15 + [i] * 12 + [p]
    lib.mips_topk_select_deep_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_sm(device) -> int:
    """The SMs of CUDA ``device`` (read once per device)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def on_device(device):
    """A context that makes ``device`` current for a launch, or nothing
    when it already is (a launch goes to the current device)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _select_launch(q, y, k: int, vals, ids, *, valid, id_offset: int,
                   kcap, scores=None):
    """Launch the ``k > SMALL_K`` chain into ``vals`` / ``ids`` (checked
    inputs, ``k ≤ C``) and return the per-row collect counts. ``kcap``
    replaces the plan's (``k ≤ kcap ≤ MAX_SORT``): a small one makes rows
    overflow into the finishing sweep. With ``scores`` (a workspace of at
    least ``C·n_q`` f32) the deep variant runs on it."""
    n_q, d = q.shape
    c = y.shape[0]
    sms = n_sm(q.device)
    sp = select_plan(n_q, c, d, k, sms)
    if kcap is not None:
        sp = dataclasses.replace(sp, kcap=kcap)
    fin = plan(n_q, c, d, k, sms)
    dev = q.device

    def scratch(*shape):
        return (torch.empty(shape, dtype=torch.float32, device=dev),
                torch.empty(shape, dtype=torch.int32, device=dev))

    uv, ui = scratch(n_q, UNION_PER_SPLIT * sp.n_split)
    tau_v, tau_i = scratch(n_q)
    count = torch.empty(n_q, dtype=torch.int32, device=dev)
    bv, bi = scratch(n_q, sp.kcap)
    part_v, part_i = scratch(n_q, fin.n_split, k)
    lib = _lib()
    entry, head = lib.mips_topk_select_launch, ()
    if scores is not None:
        entry, head = lib.mips_topk_select_deep_launch, (scores.data_ptr(),)
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(
            q.data_ptr(), y.data_ptr(),
            valid.data_ptr() if valid is not None else None, *head,
            uv.data_ptr(), ui.data_ptr(), tau_v.data_ptr(), tau_i.data_ptr(),
            count.data_ptr(), bv.data_ptr(), bi.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), n_q, c, d, k, id_offset, sp.n_split, sp.period,
            sp.collect_split, sp.kcap, fin.n_split, fin.split_cols,
            bf16_flag(q.dtype), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"mips_topk launch failed: cudaError {err} "
            f"(n_q={n_q}, C={c}, d={d}, k={k}, plan={sp}, finish={fin})"
        )
    return count


def mips_topk(q, y, k: int, *, valid=None, id_offset: int = 0, kcap=None):
    """Per-row top-``k`` of ``q @ yᵀ`` on the card, without the
    ``(n_q, C)`` score matrix.

    Parameters
    ----------
    q : (n_q, d) float32 or bfloat16 CUDA tensor, contiguous; any d > 0
        (above ``MAX_D`` the deep variant, :func:`is_deep`).
    y : (C, d) CUDA tensor of q's dtype, contiguous (catalog, or a
        shard).
    k : top-k size, clamped to ``C``; at most ``MAX_K`` (1024) after the
        clamp (above ``SHALLOW_MAX_K`` the deep variant).
    valid : optional (C,) contiguous bool — rows with False are never
        selected.
    id_offset : global id of ``y``'s first row.
    kcap : for ``k > SMALL_K``, the collect entries per row in place of
        the plan's (``k ≤ kcap ≤ MAX_SORT``): rows that collect more are
        finished by the split sweep, so a small one drives that path (the
        guard's canary). Ignored for ``k ≤ SMALL_K``.

    Returns
    -------
    (vals (n_q, k) float32, ids (n_q, k) int32): values descending, ties
    to the lower id, ``ID_PAD`` where fewer than ``k`` rows are valid —
    the contract of ``ref.mips_topk_ref``.
    """
    c = y.shape[0]
    k = min(k, c)
    _check(q, y, valid, k, id_offset, kcap)
    n_q, d = q.shape
    dev = q.device
    if n_q > 0 and is_deep(d, k):
        vals, ids = _deep(q, y, k, valid=valid, id_offset=id_offset,
                          kcap=kcap)
        mips_topk.launches += 1
        mips_topk.launches_by_k[k] += 1
        return vals, ids
    if n_q == 0 or k > SMALL_K:
        vals = torch.empty((n_q, k), dtype=torch.float32, device=dev)
        ids = torch.empty((n_q, k), dtype=torch.int32, device=dev)
        if n_q == 0:
            return vals, ids
        mips_topk.last_counts = _select_launch(
            q, y, k, vals, ids, valid=valid, id_offset=id_offset, kcap=kcap)
        mips_topk.launches += 1
        mips_topk.launches_by_k[k] += 1
        return vals, ids
    vals, ids = _sweep_launch(q, y, k, valid=valid, id_offset=id_offset)
    mips_topk.launches += 1
    mips_topk.launches_by_k[k] += 1
    return vals, ids


def _sweep_launch(q, y, k: int, *, valid, id_offset: int, scores=None):
    """The ``k ≤ SMALL_K`` sweep of checked inputs → ``(vals, ids)``;
    with ``scores`` (at least ``C·slab_ld(n_q)`` f32) the deep variant on
    it."""
    n_q, d = q.shape
    c = y.shape[0]
    dev = q.device
    p = sweep_plan(n_q, c, d, k, n_sm(dev))
    # One allocation for the outputs and the scratch, in 4-byte words:
    # vals and ids (n_q, k), the split lists (n_q, S, k), τ (n_q,) and the
    # pre-pass's union (n_q, pre_split, 8·WM).
    nk = n_q * k
    ns = nk * p.n_split
    nu = n_q * p.pre_split * 8 * SWEEP_WM[p.query_tiles]
    buf = torch.empty(2 * nk + 2 * ns + n_q + nu, dtype=torch.int32,
                      device=dev)
    vals = buf[:nk].view(torch.float32).view(n_q, k)
    ids = buf[nk:2 * nk].view(n_q, k)
    at = buf.data_ptr()
    tau = at + 8 * (nk + ns)
    lib = _lib()
    entry, head = lib.mips_topk_launch, ()
    if scores is not None:
        entry, head = lib.mips_topk_deep_launch, (scores.data_ptr(),)
    with on_device(dev):
        err = entry(
            q.data_ptr(), y.data_ptr(),
            valid.data_ptr() if valid is not None else None, *head,
            at + 8 * nk, at + 8 * nk + 4 * ns, tau,
            tau + 4 * n_q if nu else None, at, at + 4 * nk, n_q, c, d, k,
            p.query_tiles, p.n_split,
            p.pre_split, p.pre_period, id_offset, bf16_flag(q.dtype),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"mips_topk launch failed: cudaError {err} "
            f"(n_q={n_q}, C={c}, d={d}, k={k}, plan={p})"
        )
    return vals, ids


def _deep(q, y, k: int, *, valid, id_offset: int, kcap):
    """The deep variant of checked inputs: the queries in slabs of
    :func:`slab_rows`, each scored into one ``(C, slab_ld(rows))``
    workspace (the chain reads it at a pitch of ``rows``) and
    selected from it by the sweep (``k ≤ SMALL_K``) or the chain."""
    n_q = q.shape[0]
    c = y.shape[0]
    rows = slab_rows(n_q, c)
    scores = torch.empty(c * slab_ld(rows), dtype=torch.float32,
                         device=q.device)
    if k <= SMALL_K:
        parts = [_sweep_launch(q[r:r + rows], y, k, valid=valid,
                               id_offset=id_offset, scores=scores)
                 for r in range(0, n_q, rows)]
        return (torch.cat([v for v, _ in parts]),
                torch.cat([i for _, i in parts]))
    vals = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    ids = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    counts = [_select_launch(q[r:r + rows], y, k, vals[r:r + rows],
                             ids[r:r + rows], valid=valid,
                             id_offset=id_offset, kcap=kcap, scores=scores)
              for r in range(0, n_q, rows)]
    mips_topk.last_counts = torch.cat(counts)
    return vals, ids


mips_topk.launches = 0
mips_topk.launches_by_k = collections.Counter()
mips_topk.last_counts = None
