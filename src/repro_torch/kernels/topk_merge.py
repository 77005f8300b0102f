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
the buffer and tile arrive in. The reference's second merge, a bitonic
partial sort (:func:`merge_topk_tile_bitonic`), gives the same outputs.
The CUDA kernel (``csrc/mips_topk.cu``) keeps the same key with an
insertion merge.
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


def _precedes(va, ia, vb, ib):
    """The merge's total order: ``a`` comes before ``b`` iff its value is
    larger, or equal with the lower id — the tie rule both merges keep."""
    return (va > vb) | ((va == vb) & (ia < ib))


def merge_topk_tile_bitonic(vals, ids, tile_vals, tile_ids, k: int):
    """The bitonic partial-sort merge (``merge_impl="bitonic"``): the same
    outputs as :func:`merge_topk_tile` — values, ids, tie order and
    ``ID_PAD`` in exhausted slots — by another cost shape.

    It sorts the ``(k + t)``-wide concatenation of buffer and tile on the
    key (value descending, id ascending) with a bitonic network, padded
    to a power of two ``W`` with ``(NEG_INF, ID_PAD)``, and keeps the
    first ``k`` lanes: ``O(log² W)`` compare-exchange stages of ``O(W)``
    work. Each stage's partner ``lane ^ j`` is a static reshape and flip
    (blocks of ``j`` lanes swapped pairwise), no gather. Real entries have
    distinct ids, so the key is strict on them and the order is
    deterministic; slots left at ``NEG_INF`` report ``ID_PAD``.
    """
    cat_v = torch.cat([vals, tile_vals], dim=-1)
    cat_i = torch.cat([ids, tile_ids.to(ids.dtype)], dim=-1)
    w = cat_v.shape[-1]
    big = 1 << max(w - 1, 0).bit_length()  # the next power of two >= w
    if big > w:
        cat_v = torch.nn.functional.pad(cat_v, (0, big - w), value=NEG_INF)
        cat_i = torch.nn.functional.pad(cat_i, (0, big - w), value=ID_PAD)
    lead = cat_v.shape[:-1]

    def partner(a, j):
        # lane ^ j as a static permutation: swap adjacent j-blocks
        a = a.reshape(*lead, big // (2 * j), 2, j)
        return torch.flip(a, dims=(-2,)).reshape(*lead, big)

    lane = torch.arange(big, device=cat_v.device)
    size = 2
    while size <= big:
        j = size // 2
        while j >= 1:
            pv, pi = partner(cat_v, j), partner(cat_i, j)
            # the lower lane of each pair takes the first of the two in
            # ascending blocks, the second in descending ones
            want_first = ((lane & j) == 0) == ((lane & size) == 0)
            keep = _precedes(cat_v, cat_i, pv, pi) == want_first
            cat_v = torch.where(keep, cat_v, pv)
            cat_i = torch.where(keep, cat_i, pi)
            j //= 2
        size *= 2
    v, i = cat_v[..., :k], cat_i[..., :k]
    return v, torch.where(v == NEG_INF, torch.full_like(i, ID_PAD), i)


MERGES = {"rounds": merge_topk_tile, "bitonic": merge_topk_tile_bitonic}


def merge_fn(merge_impl: str):
    """The tile merge ``merge_impl`` names (``"rounds"``: the reference's
    K-round merge, whose outputs :func:`merge_topk_tile` gives;
    ``"bitonic"``: :func:`merge_topk_tile_bitonic`). Raises ``ValueError``
    on another name."""
    if merge_impl not in MERGES:
        raise ValueError(f"merge_impl {merge_impl!r}: expected one of "
                         f"{sorted(MERGES)}")
    return MERGES[merge_impl]


def streaming_topk_elements(rows: int, k: int, block: int) -> int:
    """Analytic peak live elements of one streaming top-k pass: a
    ``(rows, block)`` score tile plus the ``(rows, k)`` value/id merge
    buffers — independent of the catalog size."""
    return rows * (block + 2 * k)
