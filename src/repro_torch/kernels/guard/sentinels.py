"""On-device numerics sentinels (port of
``repro/kernels/guard/sentinels.py``).

Cheap int32 counters computed from what the loss kernels already produce
(per-position losses; the online-LSE carry), carried from the loss
through the step's metrics to ``launch/train.py``'s divergence guard.
When a step strikes, the host can name WHICH kernel went non-finite
instead of only seeing a NaN scalar::

    [guard] step 12: ... (sentinels: linear_sce_nonfinite=96)

Counter names are static strings (``{kernel}_{what}``). The counts stay
on the device as 0-d int32 tensors until the trainer reads them, in the
same device→host transfer as the loss (``launch/train.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

# The kernels' masked-logit floor; an LSE at (or below) half of it means
# every candidate was masked out — a starved, degenerate row.
NEG_INF = -1e30
_DEGENERATE_LSE = NEG_INF / 2


def loss_sentinels(kernel: str, per_pos: torch.Tensor,
                   lse: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Sentinel counters for one kernel's loss output.

    ``per_pos`` is the per-position loss (any shape; a scalar works);
    ``lse`` optionally the per-position logsumexp, for degenerate rows.
    Returns ``{f"{kernel}_nonfinite": i32[, f"{kernel}_degenerate_lse":
    i32]}`` — 0-d int32 tensors on ``per_pos``'s device, zero on healthy
    steps. Reads no gradient (the counts are of detached values).
    """
    per_pos = torch.as_tensor(per_pos).detach()
    out = {f"{kernel}_nonfinite":
           (~torch.isfinite(per_pos)).sum(dtype=torch.int32)}
    if lse is not None:
        out[f"{kernel}_degenerate_lse"] = (
            torch.as_tensor(lse).detach() <= _DEGENERATE_LSE
        ).sum(dtype=torch.int32)
    return out


def merge_sentinels(*dicts: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Sum counter dicts key-wise (microbatch / multi-loss accumulation)."""
    out: Dict[str, torch.Tensor] = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out[k] + v if k in out else v
    return out


def describe_sentinels(counts: Dict) -> str:
    """Host-side: ``"linear_sce_nonfinite=96"`` for every tripped
    counter (empty string when all clear)."""
    hits = [f"{k}={int(v)}" for k, v in sorted(counts.items()) if int(v)]
    return ", ".join(hits)
