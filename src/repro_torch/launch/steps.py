"""Step factories (port of the single-device seqrec steps of
``repro/launch/steps.py``: the SCE training step and the MIPS serving
step)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.sce import SCEConfig, sce_loss
from repro_torch.eval.streaming import streaming_topk
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
                          loss_cap=None):
    """Optimizer update gated on the step's health.

    ``ok`` = loss finite AND global grad norm finite AND (with a cap)
    loss ≤ cap. On a bad step the params AND the optimizer state come
    back bit for bit as they were, the step counter included: a skipped
    step never happened as far as schedules and moments are concerned.
    The decision stays on the device (``torch.where``), as in the
    reference. → ``(params, opt_state, {"loss", "skipped", "grad_norm"})``.
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
    return keep(new_params, params), kept_opt, metrics


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


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


def _accumulate_microbatches(loss_and_grad_fn, params, batch, generator,
                             n_micro: int, accum_dtype=torch.float32, *,
                             omega=None):
    """Mean loss and gradients over ``n_micro`` microbatches, a Python
    loop with the gradients summed in ``accum_dtype`` → ``(loss, grads)``.
    ``omega`` (an injected bucket draw) serves one microbatch only."""
    if n_micro == 1:
        return loss_and_grad_fn(params, batch, generator, omega)
    if omega is not None:
        raise ValueError("an injected omega serves a single microbatch")
    parts = {k: v.chunk(n_micro, dim=0) for k, v in batch.items()}
    acc_loss = None
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                         device=p.device), params)
    for i in range(n_micro):
        mb = {k: v[i] for k, v in parts.items()}
        loss, grads = loss_and_grad_fn(params, mb, generator, None)
        acc = tree_map(lambda a, g: a + g.to(accum_dtype) / n_micro, acc,
                       grads)
        acc_loss = loss / n_micro if acc_loss is None else \
            acc_loss + loss / n_micro
    return acc_loss, tree_map(lambda g, p: g.to(p.dtype), acc, params)


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
def make_seqrec_train_step(arch, cfg, shape):
    """The SCE training step of a causal seqrec model on one device:
    SASRec forward → ``core.sce.sce_loss`` on the kernel path
    (``build_sce_config`` defaults to ``use_kernel=True``) → autograd →
    guarded AdamW at lr 1e-3. No dropout, as in the reference step, which
    passes no dropout key to the forward.

    Returns ``(train_step, (opt_init, opt_update), sce_cfg)`` with
    ``train_step(params, opt_state, batch, *, generator=None,
    omega=None, mark=None) -> (params, opt_state, metrics)``. ``batch``
    holds ``tokens``/``targets`` (B, L) int32 and ``valid`` (B, L) bool
    on the params' device, and optionally a ``loss_cap``; the bucket
    centres are drawn from ``generator`` unless ``omega`` injects the
    draw. ``mark``, when given, is called with each phase's name where
    the phase's launches end: ``"forward"``, then ``sce_loss``'s
    ``"select"`` and ``"loss_forward"``, ``"backward"`` and
    ``"optimizer"`` (``chip_smoke.py`` records a CUDA event at each).
    """
    if not cfg.causal:
        raise NotImplementedError("the BERT4Rec step is not ported")
    if arch.train_loss != "sce":
        raise NotImplementedError(f"train loss {arch.train_loss!r} is not "
                                  f"ported")
    opt_init, opt_update = make_optimizer(arch.optimizer, 1e-3)
    gb = shape.dims["batch"]
    n_micro = max(1, min(arch.microbatches.get(shape.name, 1), gb))
    n_pos = (gb // n_micro) * cfg.max_len
    if n_pos <= 0:
        raise ValueError(f"batch {gb} / {n_micro} microbatches is empty")
    sce_cfg = build_sce_config(n_pos, cfg.n_items,
                               bucket_size_y=arch.sce_bucket_size_y)
    accum_dtype = getattr(torch, arch.accum_dtype)

    def loss_and_grad(params, mb, generator, omega, mark=None):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            hidden = sasrec_lib.forward(leaves, cfg, mb["tokens"])
            x = hidden.reshape(-1, hidden.shape[-1])
            y = sasrec_lib.loss_catalog(leaves, cfg)  # shard-even slice
            if mark:
                mark("forward")
            loss = sce_loss(
                x, y, mb["targets"].reshape(-1), cfg=sce_cfg,
                valid_mask=mb["valid"].reshape(-1), generator=generator,
                omega=omega, mark=mark,
            )
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        if mark:
            mark("backward")
        return loss.detach(), _unflatten(params, grads)

    def train_step(params, opt_state, batch, *, generator=None, omega=None,
                   mark=None):
        batch, loss_cap = _pop_loss_cap(batch)
        loss, grads = _accumulate_microbatches(
            functools.partial(loss_and_grad, mark=mark), params, batch,
            generator, n_micro, accum_dtype, omega=omega,
        )
        out = _apply_update_guarded(opt_update, loss, grads, params,
                                    opt_state, loss_cap)
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
