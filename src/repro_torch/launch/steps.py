"""Step factories (port of ``repro/launch/steps.py``: the seqrec and LM
training steps with any registry loss and optional int8 gradient
compression, on one device or on a ``(data, model)`` mesh — SASRec's
next-item and BERT4Rec's cloze objective —, the seqrec serving steps
(MIPS top-k, top-100, candidate re-rank) on one device or on a mesh, the
LM's prefill and decode steps, the CTR models' BCE training step and
their serve and retrieval steps, and SchNet's regression step)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.distributed_sce import round_up, sce_loss_sharded
from repro_torch.core.losses import ce_chunked, ce_fused_linear, make_loss
from repro_torch.core.sce import SCEConfig, sce_loss
from repro_torch.dist.collectives import (
    all_gather,
    distributed_topk_from_local,
    gather_rows,
    psum,
)
from repro_torch.dist.sharding import (
    MODEL_AXIS,
    batch_slice,
    data_shard_index,
    local_catalog,
)
from repro_torch.eval.streaming import streaming_topk
from repro_torch.kernels import guard, ops
from repro_torch.launch.mesh import dp_size
from repro_torch.models import bert4rec as b4r_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import sasrec as sasrec_lib
from repro_torch.models import schnet as schnet_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.optim.compression import with_error_feedback_compression
from repro_torch.optim.optimizers import (
    global_norm,
    leaf_slices,
    make_optimizer,
    tree_leaves,
    tree_map,
)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------
def _member(mesh):
    if mesh is not None and not mesh.member:
        raise ValueError(f"this rank is outside the {mesh.shape} mesh")


def _pop_loss_cap(batch):
    """Split the optional ``"loss_cap"`` scalar out of a train batch:
    ``(batch without it, cap or None)``. Without a cap the step runs
    unguarded against an infinite cap."""
    batch = dict(batch)
    return batch, batch.pop("loss_cap", None)


def _apply_update_guarded(opt_update, loss, grads, params, opt_state,
                          loss_cap=None, sentinels=None):
    """Optimizer update gated on the step's health.

    ``ok`` = loss finite AND global grad norm finite AND (with a cap)
    loss ≤ cap. On a bad step the params AND the optimizer state come
    back bit for bit as they were, the step counter included: a skipped
    step never happened as far as schedules and moments are concerned.
    The decision stays on the device (``torch.where``), as in the
    reference. → ``(params, opt_state, {"loss", "skipped", "grad_norm"})``,
    plus, when the loss carried them, the kernel guard's per-kernel
    ``"sentinels"`` (0-d int32 counts on the device), so a strike can
    name the kernel that went non-finite.

    The optimizer's ``guarded_in_place`` writes the update into
    ``params`` and the moments a leaf at a time: the functional update's
    values, kept or skipped per ``ok``, without a second copy of the
    state (gemma-2 at full width needs that on one card). The params and
    optimizer state passed in are the ones returned.
    """
    gnorm = global_norm(grads)
    ok = torch.isfinite(loss) & torch.isfinite(gnorm)
    if loss_cap is not None:
        ok = ok & (loss <= loss_cap)
    metrics = {"loss": loss, "skipped": ~ok, "grad_norm": gnorm}
    if sentinels:
        metrics["sentinels"] = dict(sentinels)
    params, opt_state = opt_update.guarded_in_place(grads, opt_state,
                                                    params, ok)
    return params, opt_state, metrics


def build_sce_config(
    n_positions_local: int,
    catalog: int,
    *,
    bucket_size_y: int,
    tp: int = 1,
    use_mix: bool = True,
    use_kernel: bool = True,
    logit_softcap: Optional[float] = None,
    alpha: float = 2.0,
    beta: float = 1.0,
) -> SCEConfig:
    """The paper's parametrisation (§4.2.1) from the per-shard position
    count, with ``n_b`` rounded up to the model-axis size ``tp``."""
    cfg = SCEConfig.from_alpha_beta(
        n_positions_local, catalog, alpha=alpha, beta=beta,
        bucket_size_y=bucket_size_y, use_mix=use_mix, use_kernel=use_kernel,
    )
    return dataclasses.replace(
        cfg, n_buckets=round_up(cfg.n_buckets, tp),
        logit_softcap=logit_softcap,
    )


# Which kernel group a loss name's sentinel counters blame (the conformance
# registry's key), as in the reference; "sce" keeps the reference's
# "sce_bucket" although the port's SCE runs sce_gather, so the counter
# names stay equal. Names outside the map use the loss name itself.
_SENTINEL_KERNEL = {
    "sce": "sce_bucket",
    "ce_fused": "fused_ce",
    "ce_fused_linear": "linear_sce",
}


# The losses that are a mean of per-position terms with no draw and no
# in-batch negatives: on a data axis > 1 each shard's sum and count are
# summed over the axis. Every other loss (the sampled ones, in-batch CE,
# RECE, SCE's global buckets) sees the global rows, as under the
# reference's GSPMD, so its draws are one process's.
_PER_POSITION = ("ce", "ce_chunked", "ce_fused", "ce_fused_linear")


def _gather_plain(t, axis):
    """The global rows of a tensor without a gradient (bool through
    uint8: gloo gathers no bool)."""
    if t.dtype == torch.bool:
        return all_gather(t.to(torch.uint8), axis).flatten(0, 1).bool()
    return all_gather(t, axis).flatten(0, 1)


def _vocab_loss(x, y, targets, valid, generator, *, loss_name, sce_cfg,
                sce_mode: str, mesh, logit_softcap: Optional[float] = None,
                omega=None, mark=None):
    """Dispatch the catalog loss by its registry name (the reference's
    ``_vocab_loss``).

    ``sce_mode``: ``"exact"`` | ``"union"`` run the distributed SCE of
    ``core/distributed_sce.py`` over ``mesh`` (on one device a (1, 1)
    mesh: the reference trainer's default path); ``"gspmd"``, or no
    mesh, the global-bucket ``core.sce.sce_loss``. ``logit_softcap``
    reaches every CE variant that supports it: SCE carries it in
    ``sce_cfg``, ``ce_chunked`` caps inside its sweep, ``ce_fused_linear``
    inside the kernel's tile. ``generator`` takes the reference's
    ``k_loss``: SCE's bucket draw and the sampled losses' negatives;
    ``omega`` injects SCE's Mix draw instead (on a mesh, this rank's data
    shard's). ``mark`` sees the SCE losses' own ``"select"`` and
    ``"loss_forward"``, or one ``"loss_forward"`` after any other loss.

    On a data axis above 1 (``x``, ``targets``, ``valid``: this rank's
    rows), every loss but distributed SCE is the GLOBAL batch's, as the
    reference's: a :data:`_PER_POSITION` loss sums each shard's share
    ``mean · n_local / n_global`` over ``data`` (the sums and the counts
    summed before dividing); any other runs on the rows gathered over
    ``data`` (:func:`~repro_torch.dist.collectives.gather_rows`), the
    same draws on every rank, as ``1/D`` of it on each. Either way each
    rank's gradient is its share of the global loss's, which the step
    sums over ``data``, and the value returned is the global loss.

    Returns ``(loss, sentinels)``: the kernel guard's on-device numerics
    counters (``kernels/guard/sentinels.py``) — the loss's own
    ``aux["sentinels"]``, else the non-finite count of the loss under
    :data:`_SENTINEL_KERNEL`'s name — empty under guard policy ``off``.
    """
    aux = {}
    data = mesh.axis("data") if mesh is not None else None
    data = data if data is not None and data.size > 1 else None
    if loss_name == "sce" and sce_mode in ("exact", "union") \
            and mesh is not None:
        loss = sce_loss_sharded(x, y, targets, cfg=sce_cfg, mesh=mesh,
                                valid_mask=valid, mode=sce_mode,
                                generator=generator, omega=omega, mark=mark)
        data = None  # its mean already runs over the data axes
    else:
        if omega is not None and loss_name != "sce":
            raise ValueError(f"omega injects SCE's bucket draw; the train "
                             f"loss is {loss_name!r}")
        per_position = loss_name in _PER_POSITION
        if data is not None and not per_position:
            x = gather_rows(x, data)
            targets = _gather_plain(targets, data)
            valid = _gather_plain(valid, data)
        if loss_name == "sce":
            loss = sce_loss(x, y, targets, cfg=sce_cfg, valid_mask=valid,
                            generator=generator, omega=omega, mark=mark)
        elif loss_name == "ce_chunked":
            loss, aux = ce_chunked(x, y, targets, valid_mask=valid,
                                   logit_softcap=logit_softcap)
        elif loss_name == "ce_fused_linear":
            loss, aux = ce_fused_linear(x, y, targets, valid_mask=valid,
                                        logit_softcap=logit_softcap)
        else:
            loss, aux = make_loss(loss_name)(x, y, targets,
                                             valid_mask=valid,
                                             generator=generator)
        if mark and loss_name != "sce":
            mark("loss_forward")
        if data is not None and per_position:
            n_l = (valid.sum(dtype=torch.float32) if valid is not None
                   else torch.tensor(float(x.shape[0]), device=x.device))
            n_g = psum(n_l, data)
            loss = psum(loss * (torch.clamp(n_l, min=1.0)
                                / torch.clamp(n_g, min=1.0)), data)
        elif data is not None:
            loss = psum(loss / data.size, data)
    if guard.policy() == "off":
        return loss, {}
    sentinels = aux.get("sentinels")
    if sentinels is None:
        sentinels = guard.loss_sentinels(
            _SENTINEL_KERNEL.get(loss_name, loss_name), loss)
    return loss, sentinels


def _accumulate_microbatches(loss_and_grad_fn, params, batch, generator,
                             n_micro: int, accum_dtype=torch.float32, *,
                             omega=None, with_aux: bool = False):
    """Mean loss and gradients over ``n_micro`` microbatches, a Python
    loop with the gradients summed in ``accum_dtype`` → ``(loss, grads)``.
    ``omega`` (an injected bucket draw) serves one microbatch only.

    ``with_aux=True``: the fn returns ``(loss, aux, grads)``, ``aux`` a
    dict of on-device counters (the guard's sentinels) summed over the
    microbatches, and the result is ``(loss, aux, grads)``."""
    def call(mb, omega):
        out = loss_and_grad_fn(params, mb, generator, omega)
        if with_aux:
            return out
        loss, grads = out
        return loss, {}, grads

    if n_micro == 1:
        loss, aux, grads = call(batch, omega)
        return (loss, aux, grads) if with_aux else (loss, grads)
    if omega is not None:
        raise ValueError("an injected omega serves a single microbatch")
    parts = {k: v.chunk(n_micro, dim=0) for k, v in batch.items()}
    acc_loss, acc_aux = None, {}
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                         device=p.device), params)
    for i in range(n_micro):
        mb = {k: v[i] for k, v in parts.items()}
        loss, aux, grads = call(mb, None)
        # in place: acc + g / n, without a second accumulator, a large
        # leaf in slices (elementwise: the same values)
        for leaf in zip(tree_leaves(acc), tree_leaves(grads)):
            for a, g in leaf_slices(*leaf):
                a.add_(g.to(accum_dtype) / n_micro)
        del grads
        acc_loss = loss / n_micro if acc_loss is None else \
            acc_loss + loss / n_micro
        acc_aux = guard.merge_sentinels(acc_aux, aux)
    grads = tree_map(lambda g, p: g.to(p.dtype), acc, params)
    return (acc_loss, acc_aux, grads) if with_aux else (acc_loss, grads)


def _unflatten(tree, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(tree)


def _grads(loss, leaves, params):
    """``loss``'s gradients as a tree like ``params`` (zeros where a leaf
    took no part)."""
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return _unflatten(params, [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, grads)])


# ---------------------------------------------------------------------------
# Sequential recommenders (BERT4Rec / SASRec, the paper's own domain)
# ---------------------------------------------------------------------------
def n_microbatches(arch, shape, mesh=None) -> int:
    """The microbatches a train step of ``shape`` takes: the arch's for
    the shape's name, capped so that each spans the data axes (a row a
    shard at least), as the reference caps them."""
    gb = shape.dims.get("batch", shape.dims.get("global_batch"))
    dp = dp_size(mesh) if mesh is not None else 1
    return max(1, min(arch.microbatches.get(shape.name, 1), gb // dp))


def _optimizer(arch, lr, grad_compression):
    """The arch's optimizer, wrapped in int8 error-feedback compression
    with ``grad_compression="int8"``."""
    opt = make_optimizer(arch.optimizer, lr)
    if grad_compression is None:
        return opt
    if grad_compression != "int8":
        raise ValueError(f"grad_compression {grad_compression!r}")
    return with_error_feedback_compression(opt)


def _global_uniform(tokens, generator, mesh):
    """BERT4Rec's cloze draw on a data axis > 1: the GLOBAL microbatch's
    ``(D·b, L)`` uniform, as one process draws it, and this shard's
    block of it."""
    dp = dp_size(mesh)
    u = torch.rand((dp * tokens.shape[0],) + tuple(tokens.shape[1:]),
                   generator=generator, device=tokens.device)
    return u.chunk(dp)[data_shard_index(mesh)]


def make_seqrec_train_step(arch, cfg, shape, *, mesh=None,
                           sce_mode: str = "exact",
                           grad_compression: Optional[str] = None):
    """The training step of a seqrec model: the encoder's forward → the
    loss ``arch.train_loss`` names (:func:`_vocab_loss`; ``build_sce_config``
    defaults to ``use_kernel=True``) → autograd → guarded AdamW at lr
    1e-3. No dropout, as in the reference step, which passes no dropout
    key to the forward. Another registry loss is one
    ``dataclasses.replace(arch, train_loss=name)`` away.

    A causal config (SASRec) predicts each position's next item from
    the batch's ``targets`` where ``valid``. A bidirectional one
    (BERT4Rec, ``cfg.causal`` false) takes ``tokens`` only and applies
    the cloze mask per microbatch (``models/bert4rec.py``): the masked
    positions are the valid ones, their unmasked tokens the targets. Per
    microbatch the mask is drawn first from ``generator``, then the
    loss's draw, as the reference splits its microbatch key (``k_mask``,
    ``k_loss``); ``cloze`` injects the mask's uniform draw instead, a
    ``(B, L)`` float tensor cut into microbatches like the batch.

    With ``mesh`` (``launch/mesh.py``) and ``sce_mode`` ``"exact"`` or
    ``"union"``, SCE is ``core.distributed_sce.sce_loss_sharded`` over the
    mesh, as the reference trainer runs it; ``mesh=None`` or ``"gspmd"``
    keeps ``core.sce.sce_loss``. On a mesh each rank passes its data
    shard of the global batch, the SCE config follows the per-shard
    position count with ``n_b`` rounded to the model axis, and with a
    data axis above 1 every loss is the global batch's
    (:func:`_vocab_loss`) and the step sums the gradients over the data
    group before the guarded update (the reference gets that sum from
    ``jit``). With microbatches the reference shards each GLOBAL
    microbatch, so a rank's rows are its block of every microbatch,
    microbatch-major: ``dist.sharding.batch_rows(mesh, B,
    n_microbatches(arch, shape, mesh))``. BERT4Rec's
    cloze draw there is the global microbatch's, cut to the shard's
    block. ``grad_compression="int8"`` wraps the optimizer in
    ``optim/compression.py``'s error feedback.

    Returns ``(train_step, (opt_init, opt_update), sce_cfg)`` with
    ``train_step(params, opt_state, batch, *, generator=None,
    omega=None, cloze=None, mark=None) -> (params, opt_state,
    metrics)``. ``batch`` holds ``tokens`` (B, L) int32 and, for a causal
    config, ``targets`` (B, L) int32 and ``valid`` (B, L) bool, on the
    params' device, and optionally a ``loss_cap``; the bucket centres are
    drawn from ``generator`` unless ``omega`` injects the draw (SCE only;
    one microbatch). ``mark``, when given, is called with each phase's
    name where the phase's launches end: ``"forward"``, then the SCE
    losses' ``"select"`` and ``"loss_forward"`` (another loss: one
    ``"loss_forward"``), ``"backward"`` and ``"optimizer"``
    (``chip_smoke.py`` records a CUDA event at each).
    """
    if sce_mode not in ("exact", "union", "gspmd"):
        raise ValueError(f"sce_mode {sce_mode!r}")
    _member(mesh)
    bidirectional = not cfg.causal
    opt_init, opt_update = _optimizer(arch, 1e-3, grad_compression)
    gb = shape.dims["batch"]
    dp = dp_size(mesh) if mesh is not None else 1
    tp = mesh.shape["model"] if mesh is not None else 1
    n_micro = n_microbatches(arch, shape, mesh)
    n_pos = (gb // n_micro // dp) * cfg.max_len
    if n_pos <= 0:
        raise ValueError(f"batch {gb} / {n_micro} microbatches / {dp} data "
                         f"shards is empty")
    sce_cfg = build_sce_config(n_pos, cfg.n_items,
                               bucket_size_y=arch.sce_bucket_size_y, tp=tp)
    accum_dtype = getattr(torch, arch.accum_dtype)
    data_group = mesh.axis("data").group if mesh is not None else None

    def loss_and_grad(params, mb, generator, omega, mark=None):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            tokens = mb["tokens"]
            if bidirectional:
                uniform = mb.get("cloze")
                if uniform is None and dp > 1:
                    uniform = _global_uniform(tokens, generator, mesh)
                masked, is_masked = b4r_lib.apply_cloze_mask(
                    tokens, cfg, generator=generator, uniform=uniform)
                hidden = b4r_lib.forward(leaves, cfg, masked)
                targets, valid = tokens, is_masked
            else:
                hidden = sasrec_lib.forward(leaves, cfg, tokens)
                targets, valid = mb["targets"], mb["valid"]
            x = hidden.reshape(-1, hidden.shape[-1])
            y = sasrec_lib.loss_catalog(leaves, cfg)  # shard-even slice
            if mark:
                mark("forward")
            loss, sentinels = _vocab_loss(
                x, y, targets.reshape(-1), valid.reshape(-1),
                generator, loss_name=arch.train_loss, sce_cfg=sce_cfg,
                sce_mode=sce_mode, mesh=mesh,
                logit_softcap=getattr(cfg, "final_softcap", None),
                omega=omega, mark=mark,
            )
            grads = _grads(loss, leaves, params)
        if mark:
            mark("backward")
        return loss.detach(), sentinels, grads

    def train_step(params, opt_state, batch, *, generator=None, omega=None,
                   cloze=None, mark=None):
        batch, loss_cap = _pop_loss_cap(batch)
        if cloze is not None:
            if not bidirectional:
                raise ValueError("cloze injects BERT4Rec's mask draw; this "
                                 "config is causal")
            batch["cloze"] = cloze
        loss, sentinels, grads = _accumulate_microbatches(
            functools.partial(loss_and_grad, mark=mark), params, batch,
            generator, n_micro, accum_dtype, omega=omega, with_aux=True,
        )
        if data_group is not None:
            # Each data shard's gradient is its share of the global
            # loss's; the update needs their sum.
            for g in tree_leaves(grads):
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=data_group)
        out = _apply_update_guarded(opt_update, loss, grads, params,
                                    opt_state, loss_cap, sentinels)
        if mark:
            mark("optimizer")
        return out

    return train_step, (opt_init, opt_update), sce_cfg


# ---------------------------------------------------------------------------
# LM transformers
# ---------------------------------------------------------------------------
def make_lm_train_step(arch, cfg, shape, *, mesh=None,
                       sce_mode: str = "union",
                       grad_compression: Optional[str] = None):
    """The training step of a transformer LM (the reference's
    ``make_lm_train_step``): ``transformer.forward`` over each
    microbatch's tokens → the loss ``arch.train_loss`` names on the
    ``(B·T, d)`` hidden states against the full padded output table
    (:func:`_vocab_loss`; SCE with ``logit_softcap=cfg.final_softcap``,
    ``exact`` / ``union`` on ``mesh``, ``gspmd`` or no mesh the
    global-bucket loss; the other losses with the cap where they take
    it) plus the MoE aux loss (0 for the dense archs) → autograd → the
    gradients averaged over ``arch.microbatches[shape.name]``
    microbatches (capped so each spans the data axis) in
    ``arch.accum_dtype`` → the guarded update of ``arch.optimizer``
    (AdamW; kimi-k2's Adafactor) at lr 3e-4, written in place
    (:func:`_apply_update_guarded`), with ``grad_compression="int8"``
    through ``optim/compression.py``'s error feedback. On a data axis
    above 1 every loss is the global batch's and a rank's rows are its
    block of every microbatch, as in :func:`make_seqrec_train_step`.

    SCE's parametrisation (``build_sce_config``) follows the positions a
    microbatch holds on a shard — all of them with ``gspmd`` — with the
    arch's ``sce_bucket_size_y``, over the real vocabulary ``cfg.vocab``
    (the padded rows are phantom negatives).

    Returns ``(train_step, (opt_init, opt_update), sce_cfg)`` with
    ``train_step(params, opt_state, batch, *, generator=None,
    omega=None, mark=None) -> (params, opt_state, metrics)``; ``batch``
    holds ``tokens`` / ``targets`` (B, T) int32 and ``valid`` (B, T)
    bool on the params' device and optionally a ``loss_cap``. ``mark``
    sees ``"forward"``, the loss's phases, ``"backward"`` (each
    microbatch) and ``"optimizer"``, as in :func:`make_seqrec_train_step`.
    """
    if sce_mode not in ("exact", "union", "gspmd"):
        raise ValueError(f"sce_mode {sce_mode!r}")
    _member(mesh)
    opt_init, opt_update = _optimizer(arch, 3e-4, grad_compression)
    gb = shape.dims["global_batch"]
    seq = shape.dims["seq_len"]
    dp = dp_size(mesh) if mesh is not None else 1
    tp = mesh.shape["model"] if mesh is not None else 1
    n_micro = n_microbatches(arch, shape, mesh)
    n_pos = ((gb // n_micro) * seq if sce_mode == "gspmd"
             else (gb // n_micro // dp) * seq)
    if n_pos <= 0:
        raise ValueError(f"batch {gb} / {n_micro} microbatches / {dp} data "
                         f"shards is empty")
    sce_cfg = build_sce_config(
        n_pos, cfg.vocab,
        bucket_size_y=arch.sce_bucket_size_y, tp=tp,
        logit_softcap=cfg.final_softcap)
    accum_dtype = getattr(torch, arch.accum_dtype)
    data_group = mesh.axis("data").group if mesh is not None else None

    def loss_and_grad(params, mb, generator, omega, mark=None):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            hidden, aux = tf_lib.forward(leaves, cfg, mb["tokens"])
            x = hidden.reshape(-1, hidden.shape[-1])
            y = tf_lib.output_embedding(leaves, cfg)  # padded: phantom negs
            if mark:
                mark("forward")
            loss, sentinels = _vocab_loss(
                x, y, mb["targets"].reshape(-1), mb["valid"].reshape(-1),
                generator, loss_name=arch.train_loss, sce_cfg=sce_cfg,
                sce_mode=sce_mode, mesh=mesh,
                logit_softcap=cfg.final_softcap, omega=omega, mark=mark,
            )
            loss = loss + aux
            grads = _grads(loss, leaves, params)
        if mark:
            mark("backward")
        return loss.detach(), sentinels, grads

    def train_step(params, opt_state, batch, *, generator=None, omega=None,
                   mark=None):
        batch, loss_cap = _pop_loss_cap(batch)
        loss, sentinels, grads = _accumulate_microbatches(
            functools.partial(loss_and_grad, mark=mark), params, batch,
            generator, n_micro, accum_dtype, omega=omega, with_aux=True,
        )
        if data_group is not None:
            for g in tree_leaves(grads):
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=data_group)
        out = _apply_update_guarded(opt_update, loss, grads, params,
                                    opt_state, loss_cap, sentinels)
        if mark:
            mark("optimizer")
        return out

    return train_step, (opt_init, opt_update), sce_cfg


def make_lm_prefill_step(cfg, *, cache_len=None):
    """``prefill_step(params, tokens) -> (logits (B, 1, V_pad), cache)``:
    the prompt through ``transformer.prefill``, the last position's
    logits (softcapped, phantom rows at −1e30); the global layers' cache
    holds ``cache_len`` positions (default: the prompt's, as in the
    reference), room for ``cache_len − S`` decode steps."""

    def prefill_step(params, tokens):
        hidden, cache = tf_lib.prefill(params, cfg, tokens,
                                       cache_len=cache_len)
        return tf_lib.logits_from_hidden(params, cfg, hidden[:, -1:]), cache

    return prefill_step


def make_lm_decode_step(cfg):
    """``decode_step(params, cache, tokens, pos) -> (logits, new_cache)``:
    one token a sequence through ``transformer.decode_step``."""

    def decode_step(params, cache, tokens, pos):
        return tf_lib.decode_step(params, cfg, cache, tokens, pos)

    return decode_step


def _last_states(cfg, params, tokens) -> torch.Tensor:
    """The encoder's hidden state at the last position, ``(B, d)``
    contiguous: BERT4Rec's bidirectional forward for a non-causal
    config, SASRec's otherwise."""
    lib = sasrec_lib if cfg.causal else b4r_lib
    return lib.forward(params, cfg, tokens)[:, -1].contiguous()


def _sharded_topk(x_l, y, k, *, c_lo, c_hi, mesh):
    """The mesh paths' catalog stage: this rank's top-``min(k, C/M)`` of
    its catalog block (``local_catalog``) through ``ops.mips_topk`` at
    the block's ``id_offset`` under the window ``[c_lo, c_hi)``, merged
    over ``model`` by ``distributed_topk_from_local`` (ties to the lower
    global id) → ``(vals, ids)`` of this rank's rows."""
    y_l, offset = local_catalog(y, mesh)
    vals_l, ids_l = streaming_topk(x_l, y_l, k, c_lo=c_lo, c_hi=c_hi,
                                   id_offset=offset)
    return distributed_topk_from_local(vals_l, ids_l, k,
                                       mesh.axis(MODEL_AXIS))


def _data_sharded(cfg, mesh, k, c_lo):
    """The serve step over ``mesh``: every rank passes the same global
    ``(B, L)`` request batch; it encodes its data shard's rows
    (``batch_slice``; the data axes must divide ``B``), selects over its
    catalog block (:func:`_sharded_topk`) and gathers the rows over
    ``data``, so each rank returns the whole batch's ``(vals, ids)``."""
    @torch.inference_mode()
    def serve_step(params, tokens):
        b, dp = tokens.shape[0], dp_size(mesh)
        if b % dp:
            raise ValueError(f"{b} requests do not divide over the data "
                             f"axes ({dp})")
        x_l = _last_states(cfg, params, tokens[batch_slice(mesh, b)])
        vals, ids = _sharded_topk(x_l, sasrec_lib.loss_catalog(params, cfg),
                                  k, c_lo=c_lo, c_hi=cfg.n_items, mesh=mesh)
        data = mesh.axis("data")
        return gather_rows(vals, data), gather_rows(ids, data)

    return serve_step


def make_seqrec_mips_serve_step(cfg, *, top_k: int = 10, mesh=None):
    """MIPS-backed retrieval serving (the ``launch/serve.py`` step):
    encode the request batch (SASRec, or BERT4Rec's bidirectional
    encoder), take each history's last hidden state, and stream the
    catalog through ``kernels.ops.mips_topk`` (via
    ``eval.streaming.streaming_topk``) — no ``(B, C)`` score matrix.

    Only global ids in ``[1, n_items)`` serve: the padding row 0 and the
    phantom rows of the shard-even catalog slice are masked. Ties go to
    the lower id. ``serve_step(params, tokens)`` → ``(vals (B, top_k)
    f32, ids (B, top_k) int32)`` on the tokens' device. With ``mesh``
    (every rank calling with the same batch): the requests over the data
    axes, the catalog over ``model``, each shard's candidates merged by
    ``distributed_topk_from_local`` — (value, global id) pairs cross the
    wire, never embeddings — and every rank gets the whole batch.
    """
    _member(mesh)
    if mesh is not None:
        return _data_sharded(cfg, mesh, top_k, c_lo=1)

    @torch.inference_mode()
    def serve_step(params, tokens):
        x_last = _last_states(cfg, params, tokens)
        y = sasrec_lib.loss_catalog(params, cfg)  # shard-even slice
        return streaming_topk(x_last, y, top_k, c_lo=1, c_hi=cfg.n_items)

    return serve_step


def make_seqrec_serve_step(cfg, *, top_k: int = 100, mesh=None):
    """The top-``top_k`` items of each history's last state against the
    catalog (the reference's ``make_seqrec_serve_step``, the shapes
    ``serve_p99`` / ``serve_bulk``). As in the reference, only the
    phantom rows ``>= n_items`` are masked: the padding row 0 may serve.

    The reference scores densely and takes ``lax.top_k``; here the
    catalog streams through ``kernels.ops.mips_topk`` under the window
    ``[0, n_items)``: no ``(B, C)`` score matrix (2 GB in f32 at 512 ×
    10⁶), and the reference's tie rule, the lower id first, which
    ``torch.topk`` does not promise. ``serve_step(params, tokens)`` →
    ``(vals (B, top_k) f32, ids (B, top_k) int32)``. With ``mesh``: as
    :func:`make_seqrec_mips_serve_step`'s, each shard streaming its block
    with the phantom rows shut out by the window's ``c_hi``, merged by
    ``distributed_topk_from_local`` (the reference merges a dense
    ``(chunk, C/M)`` block through ``distributed_topk``).
    """
    _member(mesh)
    if mesh is not None:
        return _data_sharded(cfg, mesh, top_k, c_lo=0)

    @torch.inference_mode()
    def serve_step(params, tokens):
        x_last = _last_states(cfg, params, tokens)
        y = sasrec_lib.loss_catalog(params, cfg)  # shard-even slice
        return streaming_topk(x_last, y, top_k, c_lo=0, c_hi=cfg.n_items)

    return serve_step


def make_seqrec_retrieval_step(cfg, *, top_k: int = 100, mesh=None):
    """Re-rank a candidate list for one (or few) user states (the
    reference's ``make_seqrec_retrieval_step``, the shape
    ``retrieval_cand``: 1 user, 10⁶ candidates).

    ``retrieval_step(params, tokens, candidate_ids)`` → ``(vals (B,
    top_k) f32, idx (B, top_k) int32)``: ``idx`` are positions in
    ``candidate_ids``, not item ids, as the reference's ``lax.top_k``
    over the candidate scores returns them. The candidates' rows are
    gathered from the shard-even catalog slice and run through
    ``kernels.ops.mips_topk`` with their positions as ids, so ties go to
    the earlier candidate, as in the reference. Every candidate id must
    lie in ``[0, catalog_loss_size)`` (``ValueError`` otherwise).

    With ``mesh`` (every rank passing the same tokens and candidates,
    both replicated as in the reference): each model shard runs
    ``mips_topk`` over the candidates it owns (the rest masked), and the
    shards' lists merge by (value, position) —
    ``distributed_topk_from_local(ties="id")`` — since positions
    interleave across shards, so the earlier candidate still wins a tie.
    The reference ``pmax``-es a dense ``(B, n_cand)`` score matrix over
    ``model`` instead.
    """
    _member(mesh)

    @torch.inference_mode()
    def retrieval_step(params, tokens, candidate_ids):
        x_last = _last_states(cfg, params, tokens)
        y = sasrec_lib.loss_catalog(params, cfg)
        if candidate_ids.ndim != 1 or candidate_ids.numel() == 0:
            raise ValueError(f"candidate_ids must be a non-empty (N,) "
                             f"tensor, got {tuple(candidate_ids.shape)}")
        lo, hi = (int(v) for v in torch.aminmax(candidate_ids))
        if lo < 0 or hi >= y.shape[0]:
            raise ValueError(f"candidate ids span [{lo}, {hi}], outside "
                             f"the catalog [0, {y.shape[0]})")
        if mesh is None:
            return ops.mips_topk(x_last, y[candidate_ids.long()], top_k)
        k = min(top_k, candidate_ids.numel())  # one device's clamp
        y_l, offset = local_catalog(y, mesh)
        local = candidate_ids.long() - offset
        owned = (local >= 0) & (local < y_l.shape[0])
        cand = y_l[local.clamp(0, y_l.shape[0] - 1)]
        vals_l, idx_l = ops.mips_topk(x_last, cand, k, valid=owned)
        return distributed_topk_from_local(vals_l, idx_l, k,
                                           mesh.axis(MODEL_AXIS), ties="id")

    return retrieval_step


# ---------------------------------------------------------------------------
# CTR recsys (DCN-v2 / DLRM / xDeepFM)
# ---------------------------------------------------------------------------
_RECSYS_FWD = {
    "dcn-v2": recsys_lib.dcn_v2_forward,
    "dlrm-rm2": recsys_lib.dlrm_forward,
    "xdeepfm": recsys_lib.xdeepfm_forward,
}
RECSYS_INIT = {
    "dcn-v2": recsys_lib.init_dcn_v2,
    "dlrm-rm2": recsys_lib.init_dlrm,
    "xdeepfm": recsys_lib.init_xdeepfm,
}


def recsys_forward_fn(arch_name: str):
    """The forward of a CTR arch: ``fwd(params, cfg, dense, sparse_ids)
    -> logits (B,)``."""
    return _RECSYS_FWD[arch_name]


def make_recsys_train_step(arch, cfg, shape, *, mesh=None,
                           grad_compression: Optional[str] = None):
    """The training step of a CTR model (the reference's
    ``make_recsys_train_step``): the forward of ``arch.name`` → the BCE of
    the click logits (``bce_logits_loss``) → autograd → the gradients
    averaged over the arch's microbatches for ``shape`` (none for the
    published CTR archs) → guarded AdamW at lr 1e-3, written in place
    (:func:`_apply_update_guarded`), with ``grad_compression="int8"``
    through ``optim/compression.py``'s error feedback. The embedding
    tables' gradients are dense, as the reference's.

    On a mesh with a data axis above 1 each rank passes its rows of the
    global batch (``dist.sharding.batch_rows``); its loss is its share of
    the global mean (its mean over ``dp``, summed over ``data``), and the
    step sums the gradients over the data group before the update, so the
    update is the global batch's.

    Returns ``(train_step, (opt_init, opt_update))`` with
    ``train_step(params, opt_state, batch, *, generator=None, mark=None)
    -> (params, opt_state, metrics)``: ``batch`` holds ``dense`` (B,
    n_dense) f32, ``sparse_ids`` (B, n_fields, hot) int32 and ``labels``
    (B,) f32 on the params' device, and optionally a ``loss_cap``; the
    step draws nothing (``generator`` is accepted for the trainer's one
    call form). ``mark`` sees ``"forward"``, ``"backward"`` (each
    microbatch) and ``"optimizer"``.
    """
    _member(mesh)
    opt_init, opt_update = _optimizer(arch, 1e-3, grad_compression)
    fwd = recsys_forward_fn(arch.name)
    n_micro = n_microbatches(arch, shape, mesh)
    dp = dp_size(mesh) if mesh is not None else 1
    data = mesh.axis("data") if dp > 1 else None

    def loss_and_grad(params, mb, generator, omega, mark=None):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            logits = fwd(leaves, cfg, mb["dense"], mb["sparse_ids"])
            if mark:
                mark("forward")
            loss = recsys_lib.bce_logits_loss(logits, mb["labels"])
            if data is not None:
                loss = psum(loss / dp, data)
            grads = _grads(loss, leaves, params)
        if mark:
            mark("backward")
        return loss.detach(), grads

    def train_step(params, opt_state, batch, *, generator=None, mark=None):
        batch, loss_cap = _pop_loss_cap(batch)
        loss, grads = _accumulate_microbatches(
            functools.partial(loss_and_grad, mark=mark), params, batch,
            generator, n_micro)
        if data is not None:
            for g in tree_leaves(grads):
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=data.group)
        out = _apply_update_guarded(opt_update, loss, grads, params,
                                    opt_state, loss_cap)
        if mark:
            mark("optimizer")
        return out

    return train_step, (opt_init, opt_update)


def make_recsys_serve_step(arch, cfg, *, chunk: int = 65536):
    """``serve_step(params, dense, sparse_ids) -> (B,)`` click
    probabilities (the sigmoid of the logits), the rows scored ``chunk``
    at a time: serve_bulk's 262,144 rows would hold xDeepFM's MLP and
    CIN activations four times over. Rows are independent, so each row's
    value is the one-call value."""
    fwd = recsys_forward_fn(arch.name)

    @torch.inference_mode()
    def serve_step(params, dense, sparse_ids):
        return torch.cat([
            torch.sigmoid(fwd(params, cfg, d, s))
            for d, s in zip(dense.split(chunk), sparse_ids.split(chunk))])

    return serve_step


def make_recsys_retrieval_step(arch, cfg, *, item_field: int = 0,
                               chunk: int = 4096, top_k: int = 100):
    """``retrieval_step(params, dense_user, sparse_user, candidate_ids) ->
    (vals (top_k,), idx (top_k,) int32)``: one user's row scored with
    each candidate in ``item_field`` (``recsys.retrieval_scores``,
    ``chunk`` candidates a forward: at 4,096 xDeepFM's CIN product is 1.25
    GB), then ``torch.topk``. ``idx`` are positions in ``candidate_ids``,
    as the reference's ``lax.top_k`` returns them; neither promises an
    order among tied scores."""
    fwd = recsys_forward_fn(arch.name)

    @torch.inference_mode()
    def retrieval_step(params, dense_user, sparse_user, candidate_ids):
        scores = recsys_lib.retrieval_scores(
            fwd, params, cfg, dense_user, sparse_user, candidate_ids,
            item_field=item_field, chunk=chunk)
        vals, idx = torch.topk(scores, top_k)
        return vals, idx.to(torch.int32)

    return retrieval_step


# ---------------------------------------------------------------------------
# GNN (SchNet)
# ---------------------------------------------------------------------------
def make_gnn_train_step(arch, cfg, shape, *, mesh=None):
    """SchNet's regression step (the reference's ``make_gnn_train_step``):
    the loss by the batch's regime → autograd → guarded AdamW at lr
    1e-3, in place.

    * ``shape.kind == "train_sampled"`` (minibatch_lg): the node energies
      of a sampled subgraph (padded edges off through ``edge_valid``) at
      its seeds ``seed_local``, against ``targets`` (one a seed);
    * a batch with ``graph_ids`` (molecule): the energy of each of the
      shape's ``batch`` graphs against ``targets`` (one a graph);
    * else full-batch node regression (full_graph_sm, ogb_products): each
      node's energy against ``targets``, the mean over ``node_valid``
      where given, padded edges off through ``edge_valid``.

    Each loss is a mean square error. A data axis above 1 raises
    ``NotImplementedError``: the graph batches have no rows to shard
    (edge sharding over several cards is ROADMAP.md queue 1 item 14).

    Returns ``(train_step, (opt_init, opt_update))`` with
    ``train_step(params, opt_state, batch, *, generator=None, mark=None)
    -> (params, opt_state, metrics)``; ``mark`` sees ``"forward"``,
    ``"backward"`` and ``"optimizer"``.
    """
    _member(mesh)
    if mesh is not None and dp_size(mesh) > 1:
        raise NotImplementedError(
            "SchNet on a data axis above 1: its graphs have no rows to "
            "shard (edge sharding is ROADMAP.md queue 1 item 14)")
    opt_init, opt_update = _optimizer(arch, 1e-3, None)
    kind = shape.kind
    n_graphs = int(shape.dims.get("batch", 1))

    def loss_fn(p, batch):
        if kind == "train_sampled":
            e, _ = schnet_lib.node_energies(
                p, cfg, batch["node_feats"], batch["positions"],
                batch["edge_index"], edge_valid=batch["edge_valid"])
            pred = torch.index_select(e, 0, batch["seed_local"].long())
            return torch.square(pred - batch["targets"]).mean()
        if "graph_ids" in batch:  # batched molecules → per-graph energy
            energy, _ = schnet_lib.forward(
                p, cfg, batch["node_feats"], batch["positions"],
                batch["edge_index"], batch["graph_ids"], n_graphs)
            return torch.square(energy - batch["targets"]).mean()
        e, _ = schnet_lib.node_energies(
            p, cfg, batch["node_feats"], batch["positions"],
            batch["edge_index"], edge_valid=batch.get("edge_valid"))
        err = torch.square(e - batch["targets"])
        if "node_valid" in batch:
            w = batch["node_valid"].to(err.dtype)
            return (err * w).sum() / torch.clamp(w.sum(), min=1.0)
        return err.mean()

    def train_step(params, opt_state, batch, *, generator=None, mark=None):
        batch, loss_cap = _pop_loss_cap(batch)
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = loss_fn(leaves, batch)
            if mark:
                mark("forward")
            grads = _grads(loss, leaves, params)
        if mark:
            mark("backward")
        out = _apply_update_guarded(opt_update, loss.detach(), grads, params,
                                    opt_state, loss_cap)
        if mark:
            mark("optimizer")
        return out

    return train_step, (opt_init, opt_update)
