"""Distributed SCE — vocab-parallel MIPS over a ``(data, model)`` mesh
(port of ``repro/core/distributed_sce.py``).

Data layout, as in the reference:
  * ``X`` (model outputs, N×d) — rows sharded over ``data``: every rank
    passes its data shard's rows (``dist.sharding.batch_slice``);
  * ``Y`` (catalog, C×d) — rows sharded over ``model``: every rank passes
    the whole table and keeps its slice (``catalog_slice``), whose
    gradient is summed over ``model`` (``collectives.to_parts``);
  * buckets are drawn **per data shard** and shared by its model ranks.

Both modes share one skeleton: per-shard stage-1 selection
(``kernels.ops.mips_topk`` when ``cfg.use_kernel``), an ownership-masked
in-bucket partial logsumexp against the LOCAL catalog slice
(``kernels.ops.sce_gather_plse``, the hand-written ``sce_gather_plse``
kernel on the card), and a log-space merge across ``model`` (one pmax and
one psum of ``(n_b, b_x)`` floats). They differ in the candidate SET:

``"exact"`` — every model shard merges the per-shard local
  top-min(b_y, C/m) (value, id) pairs through
  ``dist.collectives.distributed_topk_from_local`` into the exact global
  top-b_y, tie order included; each shard evaluates only the candidates
  it OWNS (the rest arrive as ``cand = −1``) and the merge reassembles
  the full denominator. Same selection as one device.
``"union"`` — every shard keeps its local top-(b_y/m): no candidate
  exchange.

The gradient crosses the axes by the rules of ``dist/collectives.py``:
the loss after the merge and the positive logit after its psum are the
same on every model rank, so their gradient reaches ``x`` once; only the
per-shard partials sum over ``model``. The final mean runs over the data
axes only; a train step sums the parameters' gradients over ``data``.

On one device the mesh is (1, 1): every collective is the identity and
the path is the reference trainer's default on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sce import (
    NEG_INF,
    SCEConfig,
    _dense_topk_ids,
    _sanitize_placeholder_ids,
    apply_softcap,
    make_bucket_centers,
    per_position_max,
)
from repro_torch.dist.collectives import (
    distributed_topk_from_local,
    pmax,
    psum,
    to_parts,
)
from repro_torch.dist.sharding import (
    MODEL_AXIS,
    Mesh,
    catalog_slice,
    data_axes,
    data_shard_index,
    dp_size,
)
from repro_torch.kernels import ops as _kops
from repro_torch.kernels import ref as _kref


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def _positive_logits(x_l, y_l, t_l, tp, softcap):
    """Vocab-parallel positive-logit lookup: one psum; the targets are
    the same on every model shard, so the sum of the owned rows is the
    gather."""
    c_local = y_l.shape[0]
    local = t_l.long() - tp.index * c_local
    ok = (local >= 0) & (local < c_local)
    rows = y_l[local.clamp(0, c_local - 1)]
    rows = torch.where(ok[:, None], rows, torch.zeros_like(rows))
    pos_emb = psum(rows, tp)  # (N_local, d)
    return apply_softcap(torch.einsum("nd,nd->n", x_l, pos_emb), softcap)


def _local_topk(b, rows, k, *, use_kernel, valid=None):
    """Per-shard stage-1 MIPS → ``(vals, ids int32)``: ``ops.mips_topk``
    with ``use_kernel`` (its ``ID_PAD`` tail remapped as in
    ``core.sce._sanitize_placeholder_ids``), dense scores and a stable
    sort otherwise. Same ids and tie order either way wherever each row
    has ≥ k selectable columns."""
    b, rows = b.contiguous(), rows.contiguous()
    if use_kernel:
        vals, idx = _kops.mips_topk(b, rows, k, valid=valid)
        return vals, _sanitize_placeholder_ids(idx, valid)
    p = b @ rows.T
    if valid is not None:
        p = torch.where(valid[None, :], p, NEG_INF)
    ids = _dense_topk_ids(p, min(k, rows.shape[0]))
    return p.gather(1, ids.long()), ids


def _shard_omega(generator, mesh: Mesh, shape, device):
    """This data shard's bucket draw: one ``(D,) + shape`` draw on every
    rank, of which each keeps its shard's row — every model rank of a
    shard gets the same centres, every shard its own, and the ranks'
    generators stay in step with no exchange. (The reference folds the
    shard index into its key.)"""
    draw = torch.randn((dp_size(mesh),) + tuple(shape), generator=generator,
                       dtype=torch.float32, device=device)
    return draw[data_shard_index(mesh)]  # the reference's _data_shard_index


def _sce_inner(x_l, y_l, t_l, vm_l, omega, *, cfg: SCEConfig, mesh: Mesh,
               bucket_chunks: int, exact: bool, mark=None):
    """Shared inner of both modes (module docstring): stage-1 selection,
    the ownership-masked partial LSE over the local slice in
    ``bucket_chunks`` chunks, the pmax/psum merge across ``model``, the
    cross-bucket max and the mean over the data axes."""
    n_local, _ = x_l.shape
    c_local = y_l.shape[0]
    tp = mesh.axis(MODEL_AXIS)
    m, tp_i = tp.size, tp.index
    n_b = cfg.n_buckets
    b_x = min(cfg.bucket_size_x, n_local)
    use_kernel = cfg.use_kernel
    cap = cfg.logit_softcap

    b = make_bucket_centers(x_l, n_b, use_mix=cfg.use_mix, valid_mask=vm_l,
                            omega=omega)

    # X side: ALL buckets on every shard (needed for the local partials).
    _, idx_x = _local_topk(b, x_l.detach(), b_x, use_kernel=use_kernel,
                           valid=vm_l)  # (n_b, b_x)

    # Y side: per-shard stage-1 over the local catalog slice.
    ys = y_l.detach()
    if exact:
        # Stage 1 clips per slice, the merge per catalog, so the equality
        # with one device holds even when bucket_size_y > C/m.
        b_y_loc = min(cfg.bucket_size_y, c_local)
        vals_l, idx_l = _local_topk(b, ys, b_y_loc, use_kernel=use_kernel)
        gids_l = idx_l + tp_i * c_local
        _, cand_gids = distributed_topk_from_local(
            vals_l, gids_l, cfg.bucket_size_y, tp)  # (n_b, min(b_y, C))
        local = cand_gids - tp_i * c_local
        own = (local >= 0) & (local < c_local)
        idx_y = local.clamp(0, c_local - 1).to(torch.int32)
        # Candidates another shard owns are evaluated there: mask them
        # here with the negative-id rule of the kernels and the refs.
        gidx_y = torch.where(own, cand_gids, -1).to(torch.int32)
        k_cand = cand_gids.shape[-1]
    else:
        k_cand = max(1, min(cfg.bucket_size_y // m, c_local))
        _, idx_y = _local_topk(b, ys, k_cand, use_kernel=use_kernel)
        gidx_y = (idx_y + tp_i * c_local).to(torch.int32)
    if mark:
        mark("select")

    pos_logit_all = _positive_logits(x_l, y_l, t_l, tp, cap)

    while n_b % bucket_chunks:
        bucket_chunks -= 1
    nb_c = n_b // bucket_chunks
    # x is replicated over ``model`` but each shard's partials are its
    # own part: their gradients sum over the axis into x.
    x_parts = to_parts(x_l, tp)
    t32 = t_l.to(torch.int32)

    def chunk_partials(idx_x_c, idx_y_c, gidx_c, x_parts, y_l):
        """One bucket chunk → partial LSE over the locally owned
        candidates. The kernel gathers the candidate rows itself and
        adds dY straight into the (C_local, d) gradient."""
        ix = idx_x_c.long()
        x_b = x_parts[ix]  # (nb_c, b_x, d)
        tgt_b = t32[ix]
        if use_kernel:
            return _kops.sce_gather_plse(x_b.contiguous(), y_l, idx_y_c,
                                         tgt_b, gidx_c, logit_softcap=cap)
        return _kref.sce_bucket_plse_ref(x_b, y_l[idx_y_c.long()], tgt_b,
                                         gidx_c, cap)

    parts = []
    for c in range(bucket_chunks):
        rows = slice(c * nb_c, (c + 1) * nb_c)
        args = (idx_x[rows], idx_y[rows].contiguous(),
                gidx_y[rows].contiguous(), x_parts, y_l)
        if use_kernel:
            parts.append(chunk_partials(*args))
        else:  # rematerialised: the backward never stacks the gathers
            parts.append(checkpoint(chunk_partials, *args,
                                    use_reentrant=False))
    plse = torch.cat(parts).reshape(n_b, b_x)

    # Log-space merge across model shards: one pmax + one psum. The max
    # shift is gradient-neutral, so pmax runs on a detached copy.
    g_m = pmax(plse, tp)
    g_s = psum(torch.exp(plse - g_m), tp)
    pos_logit = pos_logit_all[idx_x.long()].to(torch.float32)
    lse = torch.logaddexp(g_m + torch.log(torch.clamp(g_s, min=1e-30)),
                          pos_logit)
    losses = lse - pos_logit  # (n_b, b_x)

    # The cross-bucket max (the reference's ``_aggregate``; ties split the
    # gradient evenly, as ``segment_max`` does).
    per_pos, covered = per_position_max(losses, idx_x, n_local,
                                        valid_mask=vm_l)
    # The merge already made the losses model-invariant: the final sum
    # runs over the data axes only.
    tot = torch.stack([per_pos.sum(), covered.to(per_pos.dtype).sum()])
    for ax in data_axes(mesh):
        tot = psum(tot, mesh.axis(ax))
    if mark:
        mark("loss_forward")
    return tot[0] / torch.clamp(tot[1], min=1.0)


def sce_loss_sharded(x, y, targets, *, cfg: SCEConfig, mesh: Mesh,
                     valid_mask=None, mode: str = "exact",
                     bucket_chunks: Optional[int] = None, generator=None,
                     omega=None, mark=None):
    """Distributed SCE loss (module docstring), the same scalar on every
    rank of the mesh.

    ``x`` (N_l, d), ``targets`` (N_l,) and ``valid_mask`` (N_l,) are this
    rank's data shard (``batch_slice`` of the global batch); ``y`` (C, d)
    is the whole catalog, ``C`` divisible by the model axis.
    ``cfg.n_buckets`` is rounded up to a multiple of the model-axis size.
    ``bucket_chunks`` chunks the partial-LSE stage (default: the
    model-axis size). The bucket centres come from ``generator``
    (:func:`_shard_omega`) unless ``omega`` injects this data shard's
    draw (``(n_b, N_l)`` with Mix, ``(n_b, d)`` without). ``mark`` sees
    ``"select"`` and ``"loss_forward"``, as in ``core.sce.sce_loss``.
    """
    if mode not in ("exact", "union"):
        raise ValueError(mode)
    tp = mesh.axis(MODEL_AXIS)
    m = tp.size
    if cfg.n_buckets % m != 0:
        cfg = dataclasses.replace(cfg, n_buckets=round_up(cfg.n_buckets, m))
    if valid_mask is None:
        valid_mask = torch.ones(x.shape[:1], dtype=torch.bool,
                                device=x.device)
    if omega is None:
        shape = ((cfg.n_buckets, x.shape[0]) if cfg.use_mix
                 else (cfg.n_buckets, x.shape[-1]))
        omega = _shard_omega(generator, mesh, shape, x.device)
    y_l = to_parts(y, tp)[catalog_slice(mesh, y.shape[0])]
    return _sce_inner(x, y_l, targets, valid_mask, omega, cfg=cfg,
                      mesh=mesh, bucket_chunks=bucket_chunks or m,
                      exact=(mode == "exact"), mark=mark)


def sce_loss_sharded_ref(x, y, targets, *, cfg: SCEConfig, dp_size: int,
                         valid_mask=None, mode: str = "exact",
                         tp_size: int = 1, omegas=None, generator=None):
    """Single-process oracle for :func:`sce_loss_sharded` over the GLOBAL
    ``x``, ``y`` and ``targets``.

    ``mode="exact"``: the full-catalog candidate top-k (the two-stage
    distributed top-k is exact → the same selection). ``mode="union"``:
    per-model-shard top-(b_y/m) over each catalog slice, concatenated.
    ``omegas`` holds the ``dp_size`` per-shard draws; without it they are
    drawn from ``generator`` as :func:`sce_loss_sharded` draws them.
    """
    if cfg.n_buckets % tp_size != 0:  # the sharded path's rounding
        cfg = dataclasses.replace(
            cfg, n_buckets=round_up(cfg.n_buckets, tp_size))
    n = x.shape[0]
    assert n % dp_size == 0
    n_l = n // dp_size
    c = y.shape[0]
    if valid_mask is None:
        valid_mask = torch.ones((n,), dtype=torch.bool, device=x.device)
    if omegas is None:
        shape = (cfg.n_buckets, n_l) if cfg.use_mix else (cfg.n_buckets,
                                                          x.shape[-1])
        omegas = torch.randn((dp_size,) + shape, generator=generator,
                             dtype=torch.float32, device=x.device)

    num = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(dp_size):
        rows = slice(i * n_l, (i + 1) * n_l)
        x_i, t_i, vm_i = x[rows], targets[rows], valid_mask[rows]
        b = make_bucket_centers(x_i, cfg.n_buckets, use_mix=cfg.use_mix,
                                valid_mask=vm_i, omega=omegas[i])
        xs, ys = x_i.detach(), y.detach()
        xp = torch.where(vm_i[None, :], b @ xs.T, NEG_INF)
        idx_x = _dense_topk_ids(xp, min(cfg.bucket_size_x, n_l)).long()
        if mode == "exact":
            idx_y = _dense_topk_ids(b @ ys.T, min(cfg.bucket_size_y, c))
        else:
            c_l = c // tp_size
            k_local = max(1, min(cfg.bucket_size_y // tp_size, c_l))
            idx_y = torch.cat([
                _dense_topk_ids(b @ ys[j * c_l:(j + 1) * c_l].T, k_local)
                + j * c_l for j in range(tp_size)], dim=-1)
        idx_y = idx_y.long()
        x_b = x_i[idx_x]
        y_b = y[idx_y]
        tgt_b = t_i[idx_x].long()
        pos_logit = apply_softcap(
            torch.einsum("nxd,nxd->nx", x_b, y[tgt_b]), cfg.logit_softcap)
        neg = apply_softcap(torch.einsum("nxd,nyd->nxy", x_b, y_b),
                            cfg.logit_softcap)
        collide = idx_y[:, None, :] == tgt_b[:, :, None]
        neg = torch.where(collide, NEG_INF, neg)
        all_logits = torch.cat([pos_logit[..., None], neg], dim=-1)
        losses = torch.logsumexp(all_logits, dim=-1) - pos_logit
        per_pos, covered = per_position_max(losses, idx_x, n_l,
                                            valid_mask=vm_i)
        num = num + per_pos.sum()
        den = den + covered.to(torch.float32).sum()
    return num / torch.clamp(den, min=1.0)
