"""The streaming top-k merge and its tie rule (port of
``repro/kernels/topk_merge.py``).

Every streaming top-k carries a ``(rows, K)`` running buffer of
(value, id) pairs across catalog tiles and merges each tile into it.
The order is the composite key (value descending, id ascending): among
equal values the lower global id wins, which is what a dense stable
top-k over the id-ordered catalog returns. Slots that never received a
real score hold ``(NEG_INF, ID_PAD)``, and any selected slot whose value
is ``NEG_INF`` reports ``ID_PAD`` rather than a masked column's id.

``torch.topk`` promises no order among ties (least of all on CUDA), so
the plain merge sorts explicitly: a stable ascending sort by id, then a
stable descending sort by value — the lexicographic key, whatever order
the buffer and tile arrive in. The CUDA kernel
(``csrc/mips_topk.cu``) keeps the same key with an insertion merge.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
ID_PAD = 2**31 - 1


def merge_topk_tile(vals, ids, tile_vals, tile_ids, k: int):
    """Merge one tile of scores into the running top-k buffer.

    Parameters
    ----------
    vals : (rows, k) f32 running values, descending; ``NEG_INF`` in
        unfilled slots.
    ids : (rows, k) int32 matching ids; ``ID_PAD`` in unfilled slots.
    tile_vals : (rows, t) f32 tile scores, already masked (``NEG_INF``
        on invalid columns).
    tile_ids : (rows, t) int32 global ids of the tile columns.
    k : buffer width.

    Returns
    -------
    (vals', ids') : the merged ``(rows, k)`` buffer, same invariants.
    """
    cat_v = torch.cat([vals, tile_vals], dim=-1)
    cat_i = torch.cat([ids, tile_ids.to(ids.dtype)], dim=-1)
    by_id = torch.sort(cat_i, dim=-1, stable=True).indices
    cat_v = torch.gather(cat_v, -1, by_id)
    cat_i = torch.gather(cat_i, -1, by_id)
    order = torch.sort(cat_v, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    new_v = torch.gather(cat_v, -1, order)
    new_i = torch.gather(cat_i, -1, order)
    new_i = torch.where(new_v == NEG_INF, torch.full_like(new_i, ID_PAD), new_i)
    return new_v, new_i


def streaming_topk_elements(rows: int, k: int, block: int) -> int:
    """Analytic peak live elements of one streaming top-k pass: a
    ``(rows, block)`` score tile plus the ``(rows, k)`` value/id merge
    buffers — independent of the catalog size."""
    return rows * (block + 2 * k)
