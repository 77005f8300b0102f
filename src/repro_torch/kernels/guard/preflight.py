"""Launch-legality and shared-memory preflight for the Hopper kernels
(port of ``repro/kernels/guard/preflight.py``, with a Hopper model in
place of the TPU's VMEM one).

Every CUDA dispatch in ``kernels/ops.py`` runs its request through
:func:`preflight` before the launch. The port's wrappers plan their own
tiles and catalog splits (``mips_topk.plan``, the 64 × 64 tiles of
``sce_gather.cu`` and ``linear_ce.cu``), so the preflight checks the
WRAPPER'S plan — its dimensions, its type and the dynamic shared memory
it will ask for — and never rewrites a launch. The one block pair a
caller still passes is the plain version's chunk (``block_c``), which
the kernels ignore; its rules keep the reference's names and outcomes.

See :data:`PREFLIGHT_RULES`'s docstring for the rules. ``repair`` means
the request is rewritten to the nearest legal value and the caller
proceeds with it (a loud warning under policy ``warn``, a raise under
``strict``);
``raise`` means a structured :class:`KernelPreflightError` naming the
rule, never a refused launch deep in the driver. A repaired request fed
back through :func:`preflight` yields no further repairs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# Shared memory one block may opt in to on sm_90 (227 KB).
MAX_SMEM = 232_448
MAX_K = 512  # kMaxSweepK of csrc/topk_tile.cuh (the top-k list length)
# Every group takes any d (above 256 its deep variant), its plans' shared
# memory (smem_budget) being the limit. mips_topk's deep chain takes
# lists to kMaxK = 1024.
K_MAX = {"mips_topk": 1024}

# The kernels take float32 or bfloat16 operands (int32 ids), the
# reference's two; a plan's shared memory is the same for both (bf16 is
# widened where it lands).
_DTYPES = ("float32", "bfloat16")

# What a non-positive chunk is repaired to (clamped to the axis): the
# defaults every ``ops`` entry ships with.
_DEFAULT_BLOCK_ROWS = 128
_DEFAULT_BLOCK_COLS = 512

# The reference's seven groups. ``eval_topk`` covers both deprecated
# two-pass entries (``eval_topk`` / ``eval_tgt_scores``), ``fused_ce``
# both ``fused_lse`` and ``fused_ce_loss``.
KNOWN_KERNELS = (
    "sce_bucket", "sce_gather", "mips_topk", "fused_ce", "linear_sce",
    "eval_fused", "eval_topk",
)

PREFLIGHT_RULES = (
    "unknown_kernel", "positive_dims", "dtype_supported", "k_max",
    "positive_block", "block_le_dim", "smem_budget",
)
"""The rules, in the order they are checked (an attribute docstring):

  ===============  ============================================  =======
  rule             what it pins                                  outcome
  ===============  ============================================  =======
  unknown_kernel   the group is one of KNOWN_KERNELS             raise
  positive_dims    rows / cols / d / k are >= 1                  raise
  dtype_supported  float32 or bfloat16 (the .cu files take both) raise
  k_max            k <= 512 (kMaxSweepK: the top-k list slots);  raise
                   mips_topk k <= 1024 (its deep chain)
  positive_block   the plain version's chunk is >= 1             repair
  block_le_dim     the chunk never exceeds its axis (silent:     repair
                   the plain version clamps it itself)
  smem_budget      the wrapper's planned dynamic shared memory   raise
                   fits 227 KB (232,448 B) per block
  ===============  ============================================  =======

The reference's ``mxu_alignment`` rule (TPU blocks aligned to the
(8, 128) tile) does not apply on Hopper: every kernel here masks its own
ragged 64-row / 64-column tiles, so no block size needs aligning.
``vmem_budget`` becomes ``smem_budget``: the plan is the wrapper's, so an
overflow cannot be repaired by halving a block, only refused.
"""


class KernelPreflightError(ValueError):
    """A kernel request failed preflight on an unrepairable rule (or on a
    repairable one under policy ``strict``). ``rule`` names the violated
    rule, one of :data:`PREFLIGHT_RULES`. A ``ValueError``, as the
    reference's is."""

    def __init__(self, kernel: str, rule: str, message: str):
        super().__init__(
            f"[guard.preflight] {kernel}: rule {rule!r}: {message}")
        self.kernel = kernel
        self.rule = rule


@dataclasses.dataclass(frozen=True)
class Repair:
    """One repair: ``field`` moved ``old -> new`` to satisfy ``rule``.
    ``silent`` marks what the plain version does itself (no warning)."""

    rule: str
    field: str
    old: int
    new: int
    silent: bool = False


@dataclasses.dataclass
class PreflightResult:
    """Outcome of a passing preflight: the (possibly repaired) request and
    its audit trail."""

    kernel: str
    params: Dict[str, Optional[int]]  # rows/cols/d/k/block_rows/block_cols
    dtype: str
    repairs: List[Repair]
    smem_bytes: int
    smem_budget_bytes: int = MAX_SMEM

    @property
    def blocks(self) -> Tuple[Optional[int], Optional[int]]:
        return self.params["block_rows"], self.params["block_cols"]

    @property
    def loud_repairs(self) -> List[Repair]:
        return [r for r in self.repairs if not r.silent]


def _dtype_name(dtype) -> str:
    """``torch.float32`` / ``"float32"`` / numpy dtypes → ``"float32"``."""
    return str(getattr(dtype, "name", dtype)).replace("torch.", "")


def preflight(kernel: str, *, rows: int, cols: int, d: int,
              k: Optional[int] = None, dtype="float32",
              block_rows: Optional[int] = None,
              block_cols: Optional[int] = None,
              smem_bytes: int = 0) -> PreflightResult:
    """Check (and repair the chunk of) one kernel request.

    ``rows``/``cols`` are the row axis and the streamed catalog or
    candidate axis; ``d`` the width; ``k`` the list length where the
    kernel keeps one. ``block_rows``/``block_cols`` are the plain
    version's chunk (``None``: the request has none). ``smem_bytes`` is
    the dynamic shared memory per block the wrapper's plan asks for.

    Returns a :class:`PreflightResult`, or raises
    :class:`KernelPreflightError` naming the violated rule.
    """
    if kernel not in KNOWN_KERNELS:
        raise KernelPreflightError(
            kernel, "unknown_kernel",
            f"not a registered kernel (known: {', '.join(KNOWN_KERNELS)})")
    dtype = _dtype_name(dtype)
    if dtype not in _DTYPES:
        raise KernelPreflightError(
            kernel, "dtype_supported",
            f"dtype {dtype!r} unsupported (the CUDA kernels take "
            f"{list(_DTYPES)})")
    try:
        rows, cols, d = int(rows), int(cols), int(d)
        k = None if k is None else int(k)
        block_rows = None if block_rows is None else int(block_rows)
        block_cols = None if block_cols is None else int(block_cols)
        smem_bytes = int(smem_bytes)
    except (TypeError, ValueError) as e:
        raise KernelPreflightError(
            kernel, "positive_dims", f"non-integer dimension: {e}") from None
    for name, v in (("rows", rows), ("cols", cols), ("d", d)):
        if v < 1:
            raise KernelPreflightError(kernel, "positive_dims",
                                       f"{name}={v} must be >= 1")
    if k is not None and k < 1:
        raise KernelPreflightError(kernel, "positive_dims",
                                   f"k={k} must be >= 1")
    k_max = K_MAX.get(kernel, MAX_K)
    if k is not None and k > k_max:
        raise KernelPreflightError(kernel, "k_max",
                                   f"k={k} exceeds the kernels' {k_max}")

    repairs: List[Repair] = []

    def fix(rule, field, old, new, silent=False):
        if new != old:
            repairs.append(Repair(rule, field, old, new, silent))
        return new

    if block_rows is not None and block_rows < 1:
        block_rows = fix("positive_block", "block_rows", block_rows,
                         min(_DEFAULT_BLOCK_ROWS, rows))
    if block_cols is not None and block_cols < 1:
        block_cols = fix("positive_block", "block_cols", block_cols,
                         min(_DEFAULT_BLOCK_COLS, cols))
    if block_rows is not None and block_rows > rows:
        block_rows = fix("block_le_dim", "block_rows", block_rows, rows,
                         silent=True)
    if block_cols is not None and block_cols > cols:
        block_cols = fix("block_le_dim", "block_cols", block_cols, cols,
                         silent=True)
    if smem_bytes > MAX_SMEM:
        raise KernelPreflightError(
            kernel, "smem_budget",
            f"the wrapper's plan asks for {smem_bytes} B of shared memory "
            f"per block, above the {MAX_SMEM} B (227 KB) an sm_90 block "
            f"may use (d={d}, k={k})")
    return PreflightResult(
        kernel=kernel,
        params={"rows": rows, "cols": cols, "d": d, "k": k,
                "block_rows": block_rows, "block_cols": block_cols},
        dtype=dtype, repairs=repairs, smem_bytes=smem_bytes)
