"""Streaming catalog scoring (port of the ``streaming_topk`` slice of
``repro/eval/streaming.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def streaming_topk(
    x,
    y,
    k: int,
    *,
    c_lo: int = 0,
    c_hi: Optional[int] = None,
    id_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-``k`` of ``x @ yᵀ`` over the global-id window
    ``[c_lo, c_hi)`` — what the retrieval server calls per request
    micro-batch. Catalog rows outside the window (the padding row 0, the
    phantom rows ``>= n_items``) are never selected; no ``(B, C)`` score
    matrix exists. Returned ids are global (``id_offset`` included).
    """
    c = y.shape[0]
    gids = id_offset + torch.arange(c, device=y.device)
    hi = (id_offset + c) if c_hi is None else c_hi
    valid = (gids >= c_lo) & (gids < hi)
    return ops.mips_topk(x, y, min(k, c), valid=valid, id_offset=id_offset)
