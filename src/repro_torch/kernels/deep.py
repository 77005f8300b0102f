"""Where the kernels' deep variants take over, how large their f32 slabs
grow, and which operand types every kernel family takes — shared by the
wrappers of ``mips_topk``, ``eval_fused`` / ``eval_topk``, ``sce_gather``
/ ``sce_bucket`` and ``linear_ce`` / ``fused_ce``.

The resident kernels stage a row over its whole depth in shared memory,
up to ``MAX_D``; ``mips_topk``'s sweeps and resident chain hold lists of
up to ``SHALLOW_MAX_K``. Past either, a call takes the deep variant
(:func:`is_deep`): ``csrc/deep_tc.cuh``'s depth-chunked product writes an
f32 slab — the score slab ``S = Y · Qᵀ`` of ``mips_topk`` and the eval
sweeps, a catalog chunk's logits of the full CE — that the same sweeps,
chains and folds then read. :func:`slab_rows` sizes every such slab
against one budget, ``SLAB_BYTES``.

Operands (:func:`operand_dtype`): float32, or bfloat16 — the reference's
two (``src/repro/kernels/guard/preflight.py``) — both operands of a
product in one type. A bf16 operand is read as stored: widened to f32
inside the kernel where it lands (the resident kernels, whose bf16
outputs equal the f32 launch's on the widened inputs bit for bit), or
taken as bf16 by ``deep_tc.cuh``'s bf16 ``wgmma`` product (every deep
variant: the score slab, the deep SCE and full CE, whose outputs are the
bf16 product's, within f32 rounding of f64 and repeating bit for bit);
every product accumulates in f32.
"""
from __future__ import annotations

import torch

MAX_D = 256  # kMaxD in csrc/tf32x3_tile.cuh and csrc/topk_tile.cuh
SHALLOW_MAX_K = 512  # kMaxSweepK in csrc/topk_tile.cuh
SLAB_BYTES = 1 << 30  # a deep call's f32 slab at most
DEEP_SMEM = 229_376  # deep_tc::kSmem: the deep product's shared memory
SLAB_ALIGN = 128  # deep_tc::kBM / kBN: whole output tiles
OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def is_deep(d: int, k: int = 0) -> bool:
    """Whether a call at depth ``d`` (and, for ``mips_topk``, list length
    ``k``) takes the deep variant: exactly where the resident kernels
    cannot, ``d > MAX_D`` or ``k > SHALLOW_MAX_K``."""
    return d > MAX_D or k > SHALLOW_MAX_K


def slab_rows(n: int, width: int, *, multiple: int = 1,
              entry_bytes: int = 4) -> int:
    """Rows of ``n`` that one deep launch takes, so that its ``(rows,
    width)`` slab of ``entry_bytes`` an entry (f32: 4) stays within
    ``SLAB_BYTES``: a multiple of ``SLAB_ALIGN`` from there up, else of
    ``multiple``; at least ``multiple``, at most ``n`` rounded up to
    ``multiple``. ``mips_topk`` and the eval sweeps take query rows
    against a catalog of ``width`` (multiple 1); the full CE takes catalog
    rows against ``width`` positions (multiple 4: the slab's rows start
    16-byte aligned; on bf16 operands 6 bytes an entry, the f32 logits
    and their bf16 cotangent)."""
    rows = max(1, SLAB_BYTES // (entry_bytes * max(width, 1)))
    rows -= rows % (SLAB_ALIGN if rows >= SLAB_ALIGN else multiple)
    return min(max(rows, multiple), -(-n // multiple) * multiple)


def operand_dtype(op: str, *operands) -> torch.dtype:
    """The one element type of a kernel's product operands: float32 or
    bfloat16, the same for all; raises ``TypeError`` on a mix (say x bf16
    and y f32) and on any other type (float64, float16)."""
    kinds = {t.dtype for t in operands}
    if len(kinds) != 1 or not kinds <= set(OPERAND_DTYPES):
        raise TypeError(f"{op} takes float32 or bfloat16 operands of one "
                        f"type, got {[str(t.dtype) for t in operands]}")
    return kinds.pop()


def bf16_flag(dtype: torch.dtype) -> int:
    """The sources' ``bf16_in`` argument: 1 for bfloat16 operands."""
    return int(dtype == torch.bfloat16)


def f32_like(t, want=True):
    """An f32 buffer of ``t``'s shape on its device, or None unless
    ``want``: a gradient the kernels write in f32, rounded to ``t``'s type
    once after."""
    return (torch.empty(t.shape, dtype=torch.float32, device=t.device)
            if want else None)


def f32_rows(*rows):
    """Per-row inputs (a positive logit, an lse, an upstream cotangent)
    as the kernels read them: contiguous f32. A bf16 model's are widened
    here; they are no product's operand."""
    return tuple(r.to(torch.float32).contiguous() for r in rows)
