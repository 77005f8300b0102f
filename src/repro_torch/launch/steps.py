"""Step factories (port of the seqrec steps of ``repro/launch/steps.py``:
the training step with any registry loss, on one device or on a
``(data, model)`` mesh with distributed SCE, and the single-device MIPS
serving step)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.distributed_sce import round_up, sce_loss_sharded
from repro_torch.core.losses import ce_chunked, ce_fused_linear, make_loss
from repro_torch.core.sce import SCEConfig, sce_loss
from repro_torch.eval.streaming import streaming_topk
from repro_torch.kernels import guard
from repro_torch.launch.mesh import dp_size
from repro_torch.models import sasrec as sasrec_lib
from repro_torch.optim.optimizers import (
    OptState,
    global_norm,
    make_optimizer,
    tree_leaves,
    tree_map,
)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------
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
    """
    gnorm = global_norm(grads)
    ok = torch.isfinite(loss) & torch.isfinite(gnorm)
    if loss_cap is not None:
        ok = ok & (loss <= loss_cap)
    new_params, new_opt = opt_update(grads, opt_state, params)

    def keep(new, old):
        return tree_map(lambda n, o: torch.where(ok, n, o), new, old)

    kept_opt = OptState(step=torch.where(ok, new_opt.step, opt_state.step),
                        inner=keep(new_opt.inner, opt_state.inner))
    metrics = {"loss": loss, "skipped": ~ok, "grad_norm": gnorm}
    if sentinels:
        metrics["sentinels"] = dict(sentinels)
    return keep(new_params, params), kept_opt, metrics


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

    Returns ``(loss, sentinels)``: the kernel guard's on-device numerics
    counters (``kernels/guard/sentinels.py``) — the loss's own
    ``aux["sentinels"]``, else the non-finite count of the loss under
    :data:`_SENTINEL_KERNEL`'s name — empty under guard policy ``off``.
    """
    aux = {}
    if loss_name == "sce":
        if sce_mode in ("exact", "union") and mesh is not None:
            loss = sce_loss_sharded(x, y, targets, cfg=sce_cfg, mesh=mesh,
                                    valid_mask=valid, mode=sce_mode,
                                    generator=generator, omega=omega,
                                    mark=mark)
        else:
            loss = sce_loss(x, y, targets, cfg=sce_cfg, valid_mask=valid,
                            generator=generator, omega=omega, mark=mark)
    else:
        if omega is not None:
            raise ValueError(f"omega injects SCE's bucket draw; the train "
                             f"loss is {loss_name!r}")
        if loss_name == "ce_chunked":
            loss, aux = ce_chunked(x, y, targets, valid_mask=valid,
                                   logit_softcap=logit_softcap)
        elif loss_name == "ce_fused_linear":
            loss, aux = ce_fused_linear(x, y, targets, valid_mask=valid,
                                        logit_softcap=logit_softcap)
        else:
            loss, aux = make_loss(loss_name)(x, y, targets,
                                             valid_mask=valid,
                                             generator=generator)
        if mark:
            mark("loss_forward")
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
        acc = tree_map(lambda a, g: a + g.to(accum_dtype) / n_micro, acc,
                       grads)
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
        return next(it)

    return walk(tree)


# ---------------------------------------------------------------------------
# Sequential recommenders (SASRec, the paper's own domain)
# ---------------------------------------------------------------------------
def make_seqrec_train_step(arch, cfg, shape, *, mesh=None,
                           sce_mode: str = "exact"):
    """The training step of a causal seqrec model: SASRec forward → the
    loss ``arch.train_loss`` names (:func:`_vocab_loss`; ``build_sce_config``
    defaults to ``use_kernel=True``) → autograd → guarded AdamW at lr
    1e-3. No dropout, as in the reference step, which passes no dropout
    key to the forward. Another registry loss is one
    ``dataclasses.replace(arch, train_loss=name)`` away.

    With ``mesh`` (``launch/mesh.py``) and ``sce_mode`` ``"exact"`` or
    ``"union"``, SCE is ``core.distributed_sce.sce_loss_sharded`` over the
    mesh, as the reference trainer runs it; ``mesh=None`` or ``"gspmd"``
    keeps ``core.sce.sce_loss``. On a mesh each rank passes its data
    shard of the global batch (``dist.sharding.batch_slice``), the SCE
    config follows the per-shard position count with ``n_b`` rounded to
    the model axis, and with a data axis above 1 the step sums the
    gradients over the data group before the guarded update (the
    reference gets that sum from ``jit``).

    Returns ``(train_step, (opt_init, opt_update), sce_cfg)`` with
    ``train_step(params, opt_state, batch, *, generator=None,
    omega=None, mark=None) -> (params, opt_state, metrics)``. ``batch``
    holds ``tokens``/``targets`` (B, L) int32 and ``valid`` (B, L) bool
    on the params' device, and optionally a ``loss_cap``; the bucket
    centres are drawn from ``generator`` unless ``omega`` injects the
    draw (SCE only). ``mark``, when given, is called with each phase's
    name where the phase's launches end: ``"forward"``, then the SCE
    losses' ``"select"`` and ``"loss_forward"`` (another loss: one
    ``"loss_forward"``), ``"backward"`` and ``"optimizer"``
    (``chip_smoke.py`` records a CUDA event at each).
    """
    if not cfg.causal:
        raise NotImplementedError("the BERT4Rec step is not ported")
    if sce_mode not in ("exact", "union", "gspmd"):
        raise ValueError(f"sce_mode {sce_mode!r}")
    if mesh is not None and not mesh.member:
        raise ValueError(f"this rank is outside the {mesh.shape} mesh")
    opt_init, opt_update = make_optimizer(arch.optimizer, 1e-3)
    gb = shape.dims["batch"]
    dp = dp_size(mesh) if mesh is not None else 1
    tp = mesh.shape["model"] if mesh is not None else 1
    n_micro = max(1, min(arch.microbatches.get(shape.name, 1), gb // dp))
    if dp > 1 and not (arch.train_loss == "sce"
                       and sce_mode in ("exact", "union")):
        raise NotImplementedError(
            "on a data axis > 1 only distributed SCE (sce_mode exact or "
            "union) is ported: another loss would average each rank's "
            "shard, not the global batch")
    if n_micro > 1 and dp > 1:
        raise NotImplementedError(
            "microbatches on a data axis > 1 are not ported: the reference "
            "shards each global microbatch, a rank here holds one block")
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
            hidden = sasrec_lib.forward(leaves, cfg, mb["tokens"])
            x = hidden.reshape(-1, hidden.shape[-1])
            y = sasrec_lib.loss_catalog(leaves, cfg)  # shard-even slice
            if mark:
                mark("forward")
            loss, sentinels = _vocab_loss(
                x, y, mb["targets"].reshape(-1), mb["valid"].reshape(-1),
                generator, loss_name=arch.train_loss, sce_cfg=sce_cfg,
                sce_mode=sce_mode, mesh=mesh,
                logit_softcap=getattr(cfg, "final_softcap", None),
                omega=omega, mark=mark,
            )
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        if mark:
            mark("backward")
        return loss.detach(), sentinels, _unflatten(params, grads)

    def train_step(params, opt_state, batch, *, generator=None, omega=None,
                   mark=None):
        batch, loss_cap = _pop_loss_cap(batch)
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


def make_seqrec_mips_serve_step(cfg, *, top_k: int = 10):
    """MIPS-backed retrieval serving (the ``launch/serve.py`` step):
    encode the request batch, take each history's last hidden state, and
    stream the catalog through ``kernels.ops.mips_topk`` (via
    ``eval.streaming.streaming_topk``) — no ``(B, C)`` score matrix.

    Only global ids in ``[1, n_items)`` serve: the padding row 0 and the
    phantom rows of the shard-even catalog slice are masked. Ties go to
    the lower id. ``serve_step(params, tokens)`` → ``(vals (B, top_k)
    f32, ids (B, top_k) int32)`` on the tokens' device. Single device
    only: the mesh path is not ported.
    """

    @torch.inference_mode()
    def serve_step(params, tokens):
        hidden = sasrec_lib.forward(params, cfg, tokens)
        x_last = hidden[:, -1].contiguous()  # (B, d)
        y = sasrec_lib.loss_catalog(params, cfg)  # shard-even slice
        return streaming_topk(x_last, y, top_k, c_lo=1, c_hi=cfg.n_items)

    return serve_step
