"""AdamW and its schedules as plain ``(init, update)`` functions over a
nested dict of tensors (port of ``repro/optim/optimizers.py``).

``update(grads, state, params) -> (new_params, new_state)``; the step
counter lives in the state. AdamW keeps f32 moments whatever the
parameters' dtype. The functions return new tensors and leave their
inputs as they were, as the reference's pure functions do, so a guarded
step can keep the old state bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    inner: dict  # optimizer-specific trees


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, keys in sorted order (the order of
    ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(
        torch.sum(torch.square(x.to(torch.float32)))
        for x in tree_leaves(tree)
    ))


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled so their global norm is at most ``max_norm`` →
    ``(clipped, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# Schedules: step (int tensor) -> learning rate (f32 tensor)
# ---------------------------------------------------------------------------
def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5
                          * (1 + torch.cos(math.pi * t)))

    return fn


def linear_warmup_cosine(base_lr: float, warmup_steps: int,
                         total_steps: int, min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          min_frac)

    def fn(step):
        s = torch.as_tensor(step)
        warm = base_lr * _f32(s) / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))

    return fn


def _as_schedule(lr) -> Callable:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: Optional[float] = None):
    """AdamW with f32 moments; the decay ``wd·p`` sits inside the
    lr-scaled delta, as in the reference (the decoupled AdamW update)."""
    sched = _as_schedule(lr)

    def init(params) -> OptState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        device = tree_leaves(params)[0].device
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            inner={"m": tree_map(zeros, params),
                   "v": tree_map(zeros, params)},
        )

    @torch.no_grad()
    def update(grads, state: OptState, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr_t = sched(step)
        sf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=sf.device), sf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=sf.device), sf)

        def upd(p, g, m, v):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            p32 = p.to(torch.float32)
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p32
            return (p32 - lr_t * delta).to(p.dtype), m, v

        # (p, m, v) tuples are leaves to tree_map, which recurses into
        # dicts only.
        flat = tree_map(upd, params, grads, state.inner["m"],
                        state.inner["v"])
        new_p, new_m, new_v = (tree_map(lambda t, i=i: t[i], flat)
                               for i in range(3))
        return new_p, OptState(step=step, inner={"m": new_m, "v": new_v})

    return init, update


def make_optimizer(name: str, lr, **kwargs):
    """``(init, update)`` of the named optimizer. Only ``adamw`` is
    ported; ``adafactor`` and ``sgd`` wait in ROADMAP.md queue 1."""
    if name == "adamw":
        return adamw(lr, **kwargs)
    if name in ("adafactor", "sgd"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP.md queue 1, "
            f"item 'Last')"
        )
    raise KeyError(name)
