"""The kernel guard (port of ``repro/kernels/guard``): three layers that
sit on every CUDA dispatch of ``kernels/ops.py`` and on the losses.

  1. **Preflight** (:mod:`.preflight`) — the wrapper's launch plan
     against a Hopper model (float32, ``d <= 256``, ``k <= 512``, at most
     227 KB of shared memory per block) before the launch; a bad request
     raises a structured :class:`KernelPreflightError` naming its rule.
  2. **Conformance** (:mod:`.conformance`) — adversarial canaries per
     kernel group, each kernel against its plain version on the card;
     the verdict per ``(device, group)`` is memoized and consulted by
     every CUDA dispatch.
  3. **Sentinels** (:mod:`.sentinels`) — on-device NaN/Inf/degenerate-LSE
     counters from the losses into the trainer's ``[guard]`` line, so a
     strike names the kernel that went bad.

Policy (``REPRO_GUARD`` / :func:`set_policy` / ``train.py --guard``):

  ========  =======================================================
  policy    behavior
  ========  =======================================================
  off       no preflight, no verdicts, no sentinels
  warn      (default) a repairable preflight request (a non-positive
            chunk) is repaired with a loud warning; a failed verdict
            RAISES :class:`KernelConformanceError`
  strict    a repairable preflight request raises too; a failed
            verdict raises
  ========  =======================================================

**One deliberate deviation from the reference.** Under ``warn`` the
reference sends a kernel that failed its canaries to the plain path
(``repro/kernels/guard/__init__.py:131-158``). That fallback hides the
kernel, and this port forbids a fallback from the card to the plain
version. So here a failed verdict on a CUDA dispatch raises under both
``warn`` and ``strict``; ``warn`` differs from ``strict`` only in
preflight. A CPU dispatch runs the plain version and consults no verdict:
there is no kernel to vet.
"""
from __future__ import annotations

import functools
import os
import warnings
from typing import Optional, Tuple

from repro_torch.kernels.guard.conformance import (  # noqa: F401
    KernelConformanceError,
    Verdict,
    clear_verdicts,
    kernels,
    run_conformance,
    verdict_for,
    verdict_table,
)
from repro_torch.kernels.guard.preflight import (  # noqa: F401
    KNOWN_KERNELS,
    MAX_SMEM,
    PREFLIGHT_RULES,
    KernelPreflightError,
    PreflightResult,
    Repair,
    preflight,
)
from repro_torch.kernels.guard.sentinels import (  # noqa: F401
    describe_sentinels,
    loss_sentinels,
    merge_sentinels,
)

POLICIES = ("off", "warn", "strict")

_policy_override: Optional[str] = None


def policy() -> str:
    """Active guard policy: the :func:`set_policy` override, else the
    ``REPRO_GUARD`` environment variable, else ``"warn"``."""
    p = _policy_override or os.environ.get("REPRO_GUARD", "warn")
    if p not in POLICIES:
        raise ValueError(f"guard policy {p!r} not in {POLICIES} "
                         f"(REPRO_GUARD?)")
    return p


def set_policy(p: Optional[str]) -> None:
    """Set (or with ``None`` clear) the process-wide policy override —
    what ``train.py --guard`` and the drills use."""
    global _policy_override
    if p is not None and p not in POLICIES:
        raise ValueError(f"guard policy {p!r} not in {POLICIES}")
    _policy_override = p


def checked_blocks(kernel: str, *, rows: int, cols: int, d: int,
                   dtype="float32", k: Optional[int] = None,
                   block_rows: Optional[int] = None,
                   block_cols: Optional[int] = None,
                   smem_bytes: int = 0
                   ) -> Tuple[Optional[int], Optional[int]]:
    """Preflight one CUDA dispatch → the (possibly repaired) chunk pair.

    ``smem_bytes`` is the dynamic shared memory per block that the
    wrapper's own plan asks for. Under ``off`` the request passes
    untouched; otherwise an unrepairable request raises
    :class:`KernelPreflightError`, and a repairable one is repaired with
    a loud ``RuntimeWarning`` under ``warn`` or raises under ``strict``.
    An empty batch (``rows == 0``) launches nothing and passes.
    """
    pol = policy()
    if pol == "off" or rows == 0:
        return block_rows, block_cols
    pf = _preflight(kernel, rows, cols, d, k, str(dtype), block_rows,
                    block_cols, smem_bytes)
    loud = pf.loud_repairs
    if loud:
        fixes = ", ".join(f"{r.field} {r.old}->{r.new} ({r.rule})"
                          for r in loud)
        if pol == "strict":
            raise KernelPreflightError(kernel, loud[0].rule,
                                       f"repairable request refused under "
                                       f"policy strict: {fixes}")
        warnings.warn(f"[guard.preflight] {kernel}: repaired the request: "
                      f"{fixes}", RuntimeWarning, stacklevel=3)
    return pf.blocks


@functools.lru_cache(maxsize=256)
def _preflight(kernel, rows, cols, d, k, dtype, block_rows, block_cols,
               smem_bytes):
    """:func:`preflight` of one request, read once: it is a function of
    the request alone (a refusal raises each time, uncached)."""
    return preflight(kernel, rows=rows, cols=cols, d=d, k=k, dtype=dtype,
                     block_rows=block_rows, block_cols=block_cols,
                     smem_bytes=smem_bytes)


def kernel_enabled(kernel: str, *, device=None) -> bool:
    """Conformance gate for one CUDA dispatch on ``device``: ``True`` to
    launch the kernel. Under ``off`` no verdict is consulted. Otherwise a
    kernel group that failed its canaries raises
    :class:`KernelConformanceError`, under ``warn`` as under ``strict``
    (see the module docstring): it never returns ``False``."""
    if policy() == "off":
        return True
    v = verdict_for(kernel, device=device)
    if not v.passed:
        raise KernelConformanceError(kernel, v.device, v.failures)
    return True
