"""Plain PyTorch versions of the kernels (port of the slice of
``repro/kernels/ref.py`` this package has kernels for).

They are the CPU path of ``kernels/ops.py`` and the yardstick the tests
and ``chip_smoke.py`` hold each CUDA kernel against. No production path
takes them for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_merge import ID_PAD, NEG_INF, merge_topk_tile


def mips_topk_ref(q, y, k: int, *, valid=None, chunk: int = 512,
                  id_offset: int = 0):
    """Chunked streaming per-row top-``k`` of ``q @ yᵀ`` — the plain
    version of ``kernels/mips_topk.py``.

    Walks ``(chunk, d)`` catalog slices in f32, carrying only the
    ``(n_q, k)`` value/id buffers through :func:`merge_topk_tile`.
    ``k`` is clamped to ``C``; rows with ``valid == 0`` and nothing past
    ``C`` are ever selected; ids are ``id_offset + row`` (int32), ties go
    to the lower id and starved slots hold ``(NEG_INF, ID_PAD)``.
    → ``(vals (n_q, k) f32, ids (n_q, k) int32)``.
    """
    n_q = q.shape[0]
    c = y.shape[0]
    k = min(k, c)
    chunk = max(1, min(chunk, c))
    q32 = q.to(torch.float32)
    vals = torch.full((n_q, k), NEG_INF, dtype=torch.float32, device=q.device)
    ids = torch.full((n_q, k), ID_PAD, dtype=torch.int32, device=q.device)
    for lo in range(0, c, chunk):
        hi = min(lo + chunk, c)
        s = q32 @ y[lo:hi].to(torch.float32).T  # (n_q, hi - lo)
        if valid is not None:
            ok = valid[lo:hi].to(torch.bool)
            s = torch.where(ok[None, :], s, torch.full_like(s, NEG_INF))
        col = torch.arange(
            id_offset + lo, id_offset + hi, dtype=torch.int32, device=q.device
        ).expand(n_q, -1)
        vals, ids = merge_topk_tile(vals, ids, s, col, k)
    return vals, ids
