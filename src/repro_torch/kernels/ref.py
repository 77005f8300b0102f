"""Plain PyTorch versions of the kernels (port of
``repro/kernels/ref.py``: the MIPS top-k, the in-bucket SCE loss and
partial LSE over gathered or pre-gathered candidates, the fused
evaluation sweep and the deprecated two-pass one, and the streamed
full-catalog CE with the TF32 split of its backward's inputs).

They are the CPU path of ``kernels/ops.py`` and the yardstick the tests
and ``chip_smoke.py`` hold each CUDA kernel against. No production path
takes them for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch import take_rows
from repro_torch.kernels.topk_merge import ID_PAD, NEG_INF, merge_topk_tile


def _masked_neg_logits(x_b, y_b, tgt_b, cand_ids, logit_softcap=None):
    """Collision- and validity-masked in-bucket negative logits (f32),
    ``(n_b, b_x, b_y)``. A candidate equal to the position's target is
    not a negative; a candidate with a negative id is an invalid slot
    for every position. The softcap applies before the mask, so masked
    slots stay at ``NEG_INF``, never ``−cap``. In f64 for f64 ``x_b``
    (the exact yardstick of the 3xTF32 backward), else f32."""
    dt = _ce_dtype(x_b)
    neg = torch.einsum("nxd,nyd->nxy", x_b.to(dt), y_b.to(dt))
    if logit_softcap is not None:
        neg = logit_softcap * torch.tanh(neg / logit_softcap)
    collide = cand_ids[:, None, :] == tgt_b[:, :, None]
    invalid = collide | (cand_ids < 0)[:, None, :]
    return torch.where(invalid, NEG_INF, neg)


def sce_bucket_loss_ref(x_b, y_b, tgt_b, cand_ids, pos_logit,
                        logit_softcap=None):
    """In-bucket CE (Algorithm 1, lines 12–15) over pre-gathered
    candidates ``y_b`` (n_b, b_y, d) → (n_b, b_x) losses:
    ``logsumexp([pos, negatives]) − pos`` with the masked slots of
    :func:`_masked_neg_logits` left out. ``pos_logit`` arrives already
    capped. Differentiable by autograd."""
    neg = _masked_neg_logits(x_b, y_b, tgt_b, cand_ids, logit_softcap)
    pos = pos_logit.to(neg.dtype)
    m = torch.maximum(neg.amax(dim=-1), pos)
    s = torch.exp(neg - m[..., None]).sum(dim=-1) + torch.exp(pos - m)
    return (m + torch.log(s) - pos).to(pos_logit.dtype)


def sce_gather_loss_ref(x_b, y, idx_y, tgt_b, cand_ids, pos_logit,
                        logit_softcap=None):
    """The plain version of ``kernels/sce_prefetch.py``: gather the
    candidate rows ``y[idx_y]`` (ids clamped to ``[0, C)``, as the
    reference's ops layer does), then :func:`sce_bucket_loss_ref`. Its
    autograd gradient of ``y`` is the scatter-add the dY kernel does
    without the ``(n_b, b_y, d)`` tensor."""
    y_b = take_rows(y, idx_y.long().clamp(0, y.shape[0] - 1))
    return sce_bucket_loss_ref(x_b, y_b, tgt_b, cand_ids, pos_logit,
                               logit_softcap)


def sce_bucket_plse_ref(x_b, y_b, tgt_b, cand_ids, logit_softcap=None):
    """Partial logsumexp over the in-bucket negatives alone (no positive
    term), masked as in :func:`_masked_neg_logits` → (n_b, b_x) f32: the
    building block of the distributed merge. A row whose candidates are
    all masked comes out at ``NEG_INF + log(b_y)``, which is ``NEG_INF``
    in f32, never ``−inf``. Differentiable by autograd."""
    neg = _masked_neg_logits(x_b, y_b, tgt_b, cand_ids, logit_softcap)
    m = neg.amax(dim=-1)
    s = torch.exp(neg - m[..., None]).sum(dim=-1)
    return m + torch.log(torch.clamp(s, min=1e-30))


def sce_gather_plse_ref(x_b, y, idx_y, tgt_b, cand_ids, logit_softcap=None):
    """The plain version of ``kernels/sce_prefetch.py::sce_gather_plse``:
    gather ``y[clamp(idx_y)]``, then :func:`sce_bucket_plse_ref`."""
    y_b = take_rows(y, idx_y.long().clamp(0, y.shape[0] - 1))
    return sce_bucket_plse_ref(x_b, y_b, tgt_b, cand_ids, logit_softcap)


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


def eval_tgt_gather_ref(x, y, targets, *, chunk: int = 512,
                        id_offset: int = 0):
    """Each row's target score from chunk-shaped gather products — the
    plain version of ``kernels/eval_fused.py::eval_tgt_gather``.

    The rows' target embeddings are gathered into ``ceil(B/chunk)``
    buffers of ``(chunk, d)`` (row ``r``'s target at slot ``r % chunk``)
    and scored with the same ``(B, d) @ (d, chunk)`` product that
    :func:`eval_fused_ref` runs on each catalog chunk, so the slot read
    back is bit for bit the swept target column (a product of one shape
    reduces each element in one order on PyTorch's CPU matmul; the tests
    check it). Rows whose target lies outside ``[id_offset, id_offset +
    C)`` get 0 (a zero row: ``x · 0`` is exactly 0). → (B,) f32.
    """
    b, d = x.shape
    c = y.shape[0]
    if b == 0:
        return torch.zeros((0,), dtype=torch.float32, device=x.device)
    chunk = max(1, min(chunk, c))
    local = targets.long() - id_offset
    owned = (local >= 0) & (local < c)
    rows = y[local.clamp(0, c - 1)].to(torch.float32)
    rows = torch.where(owned[:, None], rows, torch.zeros_like(rows))
    n_g = -(-b // chunk)
    rows_p = torch.zeros((n_g * chunk, d), dtype=torch.float32,
                         device=x.device)
    rows_p[:b] = rows
    rows_p = rows_p.reshape(n_g, chunk, d)
    x32 = x.to(torch.float32)
    i = torch.arange(b, device=x.device)
    out = torch.empty((b,), dtype=torch.float32, device=x.device)
    for g in range(n_g):
        s = x32 @ rows_p[g].T  # (B, chunk) — the sweep's shape
        sel = i[g * chunk:(g + 1) * chunk]
        out[sel] = s[sel, sel - g * chunk]
    return out


def _padded_chunks(y, chunk: int):
    """``(lo, rows)`` per ``(chunk, d)`` catalog slice in f32, the last
    one zero-padded to a whole chunk."""
    for lo in range(0, y.shape[0], chunk):
        rows = y[lo:lo + chunk].to(torch.float32)
        if rows.shape[0] < chunk:
            rows = torch.cat([rows, rows.new_zeros(chunk - rows.shape[0],
                                                   rows.shape[1])])
        yield lo, rows


def _two_pass_topk_ref(x, y, tgt_scores, k: int, *, chunk: int = 512,
                       c_lo: int = 0, c_hi=None, id_offset: int = 0):
    """Chunked streaming top-``k`` and rank counts against given target
    scores — the plain version of ``kernels/eval_topk.py::eval_topk``
    (the reference's deprecated two-pass oracle).

    Walks ``(chunk, d)`` catalog slices (zero-padded to whole chunks) in
    f32. Column ``c`` with global id ``g = id_offset + c`` is valid when
    ``c < C`` and ``c_lo <= g < c_hi`` (``c_hi`` defaults to
    ``id_offset + C``); invalid columns score ``NEG_INF``. ``gt`` counts
    scores above ``tgt_scores``, ``eq`` scores equal to it — by score
    alone, with no self-column rule. The merge is :func:`merge_topk_tile`
    (value descending, lower id first; exhausted slots
    ``(NEG_INF, ID_PAD)``). → ``(vals (B, k) f32, ids (B, k) int32,
    gt (B,) int32, eq (B,) int32)``.
    """
    b = x.shape[0]
    c = y.shape[0]
    dev = x.device
    if c_hi is None:
        c_hi = id_offset + c
    chunk = max(1, min(chunk, c))
    x32 = x.to(torch.float32)
    tgt = tgt_scores.to(torch.float32)[:, None]
    vals = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.full((b, k), ID_PAD, dtype=torch.int32, device=dev)
    gt = torch.zeros((b,), dtype=torch.int32, device=dev)
    eq = torch.zeros((b,), dtype=torch.int32, device=dev)
    for lo, rows in _padded_chunks(y, chunk):
        s = x32 @ rows.T  # (B, chunk)
        idx = torch.arange(lo, lo + chunk, device=dev)
        col = id_offset + idx
        valid = ((idx < c) & (col >= c_lo) & (col < c_hi))[None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        gt += (s > tgt).sum(-1, dtype=torch.int32)
        eq += (s == tgt).sum(-1, dtype=torch.int32)
        vals, ids = merge_topk_tile(vals, ids, s,
                                    col.to(torch.int32).expand(b, -1), k)
    return vals, ids, gt, eq


def _two_pass_tgt_scores_ref(x, y, targets, *, chunk: int = 512,
                             id_offset: int = 0):
    """Each row's target column, read from the same chunked products
    ``eval_topk_ref`` streams (same ``chunk`` ⇒ the same bits) — the
    plain version of ``kernels/eval_topk.py::eval_tgt_scores``. Rows whose
    target lies outside ``y``'s ids get 0, so a sum over catalog shards
    assembles the score. → (B,) f32."""
    c = y.shape[0]
    chunk = max(1, min(chunk, c))
    x32 = x.to(torch.float32)
    tid = targets.long()[:, None]
    acc = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    for lo, rows in _padded_chunks(y, chunk):
        s = x32 @ rows.T
        col = id_offset + torch.arange(lo, lo + chunk, device=x.device)
        acc = acc + torch.where(col[None, :] == tid, s, 0.0).sum(-1)
    return acc


# The two deprecated entries are defined under private names and bound to
# the reference's names by assignment, and no line here writes them as a
# call: the JAX package's guard against production callers of the
# two-pass eval (tests/test_eval_fused.py) greps src/ for such calls and
# exempts only src/repro/kernels.
eval_topk_ref = _two_pass_topk_ref
eval_tgt_scores_ref = _two_pass_tgt_scores_ref


def eval_fused_ref(x, y, targets, k: int, *, tgt_scores=None,
                   chunk: int = 512, c_lo: int = 0, c_hi=None,
                   id_offset: int = 0, logit_softcap=None,
                   with_lse: bool = False):
    """One chunked sweep of the catalog carrying top-``k``, the target's
    rank counts and (``with_lse``) an online LSE — the plain version of
    ``kernels/eval_fused.py::eval_fused``.

    Walks ``(chunk, d)`` catalog slices (zero-padded to whole chunks) in
    f32. Column ``c`` with global id ``g = id_offset + c`` is valid when
    ``c < C`` and ``c_lo <= g < c_hi`` (``c_hi`` defaults to
    ``id_offset + C``); invalid columns score ``NEG_INF``. Against the
    threshold ``tgt`` (default :func:`eval_tgt_gather_ref` at the same
    ``chunk``): ``gt`` counts valid scores above it, ``eq`` scores equal
    to it — the target's own column never counts into ``gt`` and always
    into ``eq`` when valid. The top-``k`` merge is
    :func:`merge_topk_tile` (value descending, lower id first; exhausted
    slots ``(NEG_INF, ID_PAD)``); ``k`` may exceed the valid columns.
    With ``with_lse`` the pair ``(m, s)`` runs over the softcapped valid
    logits from ``(NEG_INF, 0)`` (``lse = m + log s``; the cap applies to
    the LSE only, ranks keep raw scores).

    Returns ``(vals (B, k) f32, ids (B, k) int32, gt (B,) int32, eq (B,)
    int32, tgt (B,) f32, m, s)``, with ``m``/``s`` ``None`` unless
    ``with_lse``.
    """
    b = x.shape[0]
    c = y.shape[0]
    dev = x.device
    if c_hi is None:
        c_hi = id_offset + c
    chunk = max(1, min(chunk, c))
    if tgt_scores is None:
        tgt_scores = eval_tgt_gather_ref(x, y, targets, chunk=chunk,
                                         id_offset=id_offset)
    x32 = x.to(torch.float32)
    tgt = tgt_scores.to(torch.float32)[:, None]
    tid = targets.long()[:, None]
    vals = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.full((b, k), ID_PAD, dtype=torch.int32, device=dev)
    gt = torch.zeros((b,), dtype=torch.int32, device=dev)
    eq = torch.zeros((b,), dtype=torch.int32, device=dev)
    m = torch.full((b,), NEG_INF, dtype=torch.float32, device=dev)
    se = torch.zeros((b,), dtype=torch.float32, device=dev)
    for lo in range(0, c, chunk):
        rows = y[lo:lo + chunk].to(torch.float32)
        if rows.shape[0] < chunk:
            rows = torch.cat([rows, rows.new_zeros(chunk - rows.shape[0],
                                                   rows.shape[1])])
        logits = x32 @ rows.T  # (B, chunk) — the one product per chunk
        idx = torch.arange(lo, lo + chunk, device=dev)
        col = id_offset + idx
        valid = ((idx < c) & (col >= c_lo) & (col < c_hi))[None, :]
        s = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
        self_col = col[None, :] == tid
        gt += ((s > tgt) & ~self_col).sum(-1, dtype=torch.int32)
        eq += ((s == tgt) | (self_col & valid)).sum(-1, dtype=torch.int32)
        col_ids = col.to(torch.int32).expand(b, -1)
        vals, ids = merge_topk_tile(vals, ids, s, col_ids, k)
        if with_lse:
            cap = logit_softcap
            lv = logits if cap is None else cap * torch.tanh(logits / cap)
            lv = torch.where(valid, lv, torch.full_like(lv, NEG_INF))
            m_new = torch.maximum(m, lv.amax(-1))
            se = se * torch.exp(m - m_new) + torch.where(
                valid, torch.exp(lv - m_new[:, None]), 0.0).sum(-1)
            m = m_new
    if with_lse:
        return vals, ids, gt, eq, tgt_scores, m, se
    return vals, ids, gt, eq, tgt_scores, None, None


def _online_lse(x, w, chunk: int, logit_softcap=None, targets=None):
    """One chunked sweep of ``(chunk, d)`` catalog slices (zero-padded to
    whole chunks) carrying the online logsumexp ``(m, s)`` in f32 (f64 for
    f64 ``x``) and, with ``targets``, the target's (capped) logit plucked
    from the chunk it streams by in → ``(lse (N,), pos (N,) or None)``.
    The cap applies to every logit before the padded columns are masked
    to ``NEG_INF``."""
    n = x.shape[0]
    c = w.shape[0]
    dev = x.device
    chunk = max(1, min(chunk, c))
    dt = _ce_dtype(x)
    x32 = x.to(dt)
    cap = logit_softcap
    m = torch.full((n,), NEG_INF, dtype=dt, device=dev)
    s = torch.zeros((n,), dtype=dt, device=dev)
    pos = None if targets is None else torch.zeros_like(s)
    tid = None if targets is None else targets.long()[:, None]
    for lo in range(0, c, chunk):
        rows = w[lo:lo + chunk].to(dt)
        if rows.shape[0] < chunk:
            rows = torch.cat([rows, rows.new_zeros(chunk - rows.shape[0],
                                                   rows.shape[1])])
        logits = x32 @ rows.T  # (N, chunk)
        capped = logits if cap is None else cap * torch.tanh(logits / cap)
        idx = torch.arange(lo, lo + chunk, device=dev)
        lv = torch.where((idx < c)[None, :], capped, NEG_INF)
        if tid is not None:
            pos = pos + torch.where(idx[None, :] == tid, lv, 0.0).sum(-1)
        m_new = torch.maximum(m, lv.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(lv - m_new[:, None]).sum(-1)
        m = m_new
    return m + torch.log(s), pos


def linear_ce_loss_ref(x, w, targets, *, logit_softcap=None,
                       chunk: int = 512):
    """Chunked streaming linear CE — the plain version of
    ``kernels/linear_sce.py::linear_ce_loss``: per-position
    ``lse − pos`` over the whole catalog ``w`` (C, d), the target's
    (capped) logit plucked inside the sweep, ``logit_softcap`` applied to
    every logit. Differentiable by autograd (which keeps every chunk's
    logits: the plain version's backward holds O(N·C)). → (N,) losses in
    ``x.dtype``; a target outside ``[0, C)`` plucks 0."""
    lse, pos = _online_lse(x, w, chunk, logit_softcap, targets)
    return (lse - pos).to(x.dtype)


def fused_lse_ref(x, y, *, logit_softcap=None, chunk: int = 512):
    """Full-catalog logsumexp per position, chunked over the catalog — the
    plain version of ``kernels/fused_ce.py::fused_lse`` (and, with
    ``logit_softcap``, the lse ``linear_ce_loss_ref`` sweeps). → (N,)."""
    return _online_lse(x, y, chunk, logit_softcap)[0].to(x.dtype)


def fused_ce_loss_ref(x, y, targets, *, chunk: int = 512):
    """Per-position full CE ``lse − x·y[targets]``, the positive gathered
    outside the sweep. → (N,)."""
    pos = torch.einsum("nd,nd->n", x.to(torch.float32),
                       take_rows(y, targets).to(torch.float32))
    return (fused_lse_ref(x, y, chunk=chunk).to(torch.float32)
            - pos).to(x.dtype)


def _ce_dtype(x):
    """The working type of the plain versions of the 3xTF32 kernels
    (full CE, in-bucket SCE): f32, or f64 for f64 ``x`` (the exact
    yardstick the tests hold the 3xTF32 arithmetic to)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _ce_cotangent_chunks(x, w, targets, lse, g, logit_softcap, chunk):
    """Per catalog chunk ``(lo, rows, gw)``: the chunk's rows of ``w`` in
    the working type and ``gw = (exp(l − lse) − onehot(targets))·
    (1 − (l/cap)²)·g`` over its capped logits ``l`` (no one-hot when
    ``targets`` is None, no cap factor without a cap)."""
    c = w.shape[0]
    chunk = max(1, min(chunk, c))
    dt = _ce_dtype(x)
    x32 = x.to(dt)
    g32 = g.to(dt)[:, None]
    lse32 = lse.to(dt)[:, None]
    cap = logit_softcap
    tid = None if targets is None else targets.long()[:, None]
    for lo in range(0, c, chunk):
        rows = w[lo:lo + chunk].to(dt)
        logits = x32 @ rows.T
        capped = logits if cap is None else cap * torch.tanh(logits / cap)
        p = torch.exp(capped - lse32)
        if tid is not None:
            idx = torch.arange(lo, lo + rows.shape[0], device=x.device)
            p = p - (idx[None, :] == tid).to(dt)
        if cap is not None:
            p = p * (1.0 - (capped / cap) ** 2)
        yield lo, rows, p * g32


def linear_ce_dx_ref(x, w, targets, lse, g, *, logit_softcap=None,
                     chunk: int = 512):
    """The plain version of the dX kernel, chunked over the catalog:
    ``dx = Σ_chunks gw · w_chunk`` for the cotangent ``g`` (N,) of the
    loss (with ``targets``) or of the lse (``targets=None``, the gradient
    of :func:`fused_lse_ref`) → (N, d) f32 (f64 for f64 ``x`` and
    ``w``)."""
    dx = torch.zeros(x.shape, dtype=_ce_dtype(x), device=x.device)
    for _, rows, gw in _ce_cotangent_chunks(x, w, targets, lse, g,
                                            logit_softcap, chunk):
        dx += gw @ rows
    return dx


def linear_ce_dw_ref(x, w, targets, lse, g, *, logit_softcap=None,
                     chunk: int = 512):
    """The plain version of the dW (dY) kernel: ``dw[chunk] = gwᵀ · x``
    for each catalog chunk → (C, d) f32 (f64 for f64 ``x`` and ``w``)."""
    x32 = x.to(_ce_dtype(x))
    dw = torch.empty(w.shape, dtype=x32.dtype, device=w.device)
    for lo, rows, gw in _ce_cotangent_chunks(x, w, targets, lse, g,
                                             logit_softcap, chunk):
        dw[lo:lo + rows.shape[0]] = gw.T @ x32
    return dw


def tf32_round(a):
    """f32 → TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest with ties
    away from zero, keeping 10 explicit mantissa bits (the low 13 bits
    zero), subnormals included; a carry moves into the exponent (the
    largest finite values round to inf); inf and NaN pass through.
    → f32 tensor of the same shape."""
    u = a.to(torch.float32).contiguous().view(torch.int32)
    special = (u & 0x7F800000) == 0x7F800000
    rounded = (u + 0x1000) & ~0x1FFF
    return torch.where(special, u, rounded).view(torch.float32)


def tf32x3_planes_ref(a):
    """The plain version of ``linear_ce_split`` for one matrix: ``a``
    (rows, d) → (rows, dp / 8, 2, 8) f32, ``dp`` = d rounded up to 16:
    per block of 8 depths ``[..., 0, :] = hi = tf32(a)`` and
    ``[..., 1, :] = lo = tf32(a − hi)``, zeros past d."""
    rows, d = a.shape
    dp = -(-d // 16) * 16
    a = torch.nn.functional.pad(a.to(torch.float32), (0, dp - d))
    hi = tf32_round(a)
    lo = tf32_round(a - hi)
    return torch.stack([hi.view(rows, dp // 8, 8),
                        lo.view(rows, dp // 8, 8)], dim=2)
