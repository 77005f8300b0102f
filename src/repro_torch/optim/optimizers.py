"""AdamW, Adafactor, SGD with momentum and the schedules as plain
``(init, update)`` functions over a nested dict of tensors (port of
``repro/optim/optimizers.py``).

``update(grads, state, params) -> (new_params, new_state)``; the step
counter lives in the state. The optimizers keep f32 state whatever the
parameters' dtype. The functions return new tensors and leave their
inputs as they were, as the reference's pure functions do.

Each update also carries ``update.guarded_in_place(grads, state,
params, ok)``, which the trainers' guarded step
(``launch/steps.py::_apply_update_guarded``) runs: the same arithmetic a
leaf at a time, each leaf's new value written over the old where the 0-d
bool ``ok`` holds (the old kept bit for bit where it does not). It needs
no second copy of the parameters and state — what lets gemma-2's 2.6 B
and granite's 3.95 B parameters and their AdamW moments train on one
card, where the functional update would hold two of each at once.
AdamW's and SGD's arithmetic is elementwise, so they take a large leaf
in slices along its first axis (``SLICE_ELEMS`` values at most), with the
same values; Adafactor's update clipping reads a whole leaf's RMS, so it
takes whole leaves.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    inner: dict  # optimizer-specific trees


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists of the same
    structure (a tuple is a leaf: the updates' per-leaf results)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, tuples (NamedTuples among them) and
    lists: dict keys in sorted order, sequence items in order, ``None``
    holding no leaf — the order of ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    if tree is None:
        return []
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


# At most this many values of a leaf at once in the elementwise in-place
# updates: their f32 temporaries stay ≤ 0.5 GiB each, whatever the leaf
# (granite's stacked experts hold 1.2 G values a leaf).
SLICE_ELEMS = 1 << 27


def leaf_slices(*leaf):
    """Views of the same tensors along their first axis, each at most
    ``SLICE_ELEMS`` values (the whole tensors when they fit)."""
    t = leaf[0]
    if t.dim() == 0 or t.numel() <= SLICE_ELEMS:
        return [leaf]
    step = max(1, SLICE_ELEMS // (t.numel() // t.shape[0]))
    return [tuple(x[i:i + step] for x in leaf)
            for i in range(0, t.shape[0], step)]


def _write_where(ok, new, old) -> None:
    """``old`` ← ``new`` where the 0-d bool ``ok`` holds, in place."""
    torch.where(ok, new, old, out=old)


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
        upd = _leaf_update(step, sched(step))
        # (p, m, v) tuples are leaves to tree_map, which recurses into
        # dicts and lists only.
        flat = tree_map(upd, params, grads, state.inner["m"],
                        state.inner["v"])
        new_p, new_m, new_v = (tree_map(lambda t, i=i: t[i], flat)
                               for i in range(3))
        return new_p, OptState(step=step, inner={"m": new_m, "v": new_v})

    def _leaf_update(step, lr_t):
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

        return upd

    @torch.no_grad()
    def guarded_in_place(grads, state: OptState, params, ok):
        """``update`` where ``ok`` holds, else nothing, written into
        ``params`` and ``state``'s moments a leaf at a time → ``(params,
        state)`` with the step counter advanced only where ``ok``."""
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        upd = _leaf_update(step, sched(step))
        for leaf in zip(tree_leaves(params), tree_leaves(grads),
                        tree_leaves(state.inner["m"]),
                        tree_leaves(state.inner["v"])):
            for p, g, m, v in leaf_slices(*leaf):
                new = upd(p, g, m, v)
                for old, n in zip((p, m, v), new):
                    _write_where(ok, n, old)
        return params, OptState(step=torch.where(ok, step, state.step),
                                inner=state.inner)

    update.guarded_in_place = guarded_in_place
    return init, update


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no first moment)
# ---------------------------------------------------------------------------
def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              min_dim_size_to_factor: int = 128):
    """Shazeer & Stern (2018), as the reference: a leaf whose last two
    axes are both ≥ ``min_dim_size_to_factor`` keeps its second moment
    as row and column means (``vr`` (…, n), ``vc`` (…, m)), any other
    leaf a full ``v``; ``β_t = 1 − t^(−decay)``; the update ``g /
    sqrt(v̂ + eps)`` scaled down so its RMS is at most
    ``clip_threshold``; the decay ``wd·p`` inside the lr-scaled delta."""
    sched = _as_schedule(lr)

    def _factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params) -> OptState:
        def leaf_state(p):
            kw = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **kw),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
            return {"v": torch.zeros(p.shape, **kw)}

        device = tree_leaves(params)[0].device
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            inner={"v": tree_map(leaf_state, params)},
        )

    def _leaf_update(step, lr_t):
        beta = 1.0 - torch.pow(step.to(torch.float32), -decay)

        def upd(p, g, s):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                v_est = vr[..., None] * vc[..., None, :] / denom[..., None]
                new_s = {"vr": vr, "vc": vc}
            else:
                v_est = beta * s["v"] + (1 - beta) * g2
                new_s = {"v": v_est}
            u = g / torch.sqrt(v_est + eps)
            # update clipping (RMS of the update ≤ clip_threshold)
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            p32 = p.to(torch.float32)
            delta = u + weight_decay * p32
            return (p32 - lr_t * delta).to(p.dtype), new_s

        return upd

    @torch.no_grad()
    def update(grads, state: OptState, params):
        step = state.step + 1
        flat = tree_map(_leaf_update(step, sched(step)), params, grads,
                        state.inner["v"])
        return (tree_map(lambda t: t[0], flat),
                OptState(step=step,
                         inner={"v": tree_map(lambda t: t[1], flat)}))

    @torch.no_grad()
    def guarded_in_place(grads, state: OptState, params, ok):
        """``update`` where ``ok`` holds, else nothing, written into
        ``params`` and the second moments a leaf at a time."""
        step = state.step + 1
        upd = _leaf_update(step, sched(step))
        leaves = []  # (p, g, s) in the tree's own order
        tree_map(lambda *t: leaves.append(t), params, grads,
                 state.inner["v"])
        for p, g, s in leaves:
            new_p, new_s = upd(p, g, s)
            _write_where(ok, new_p, p)
            for k in s:
                _write_where(ok, new_s[k], s[k])
        return params, OptState(step=torch.where(ok, step, state.step),
                                inner=state.inner)

    update.guarded_in_place = guarded_in_place
    return init, update


# ---------------------------------------------------------------------------
# SGD with momentum
# ---------------------------------------------------------------------------
def sgd_momentum(lr, momentum: float = 0.9):
    """``m ← μ·m + g`` (f32), ``p ← p − lr·m``."""
    sched = _as_schedule(lr)

    def init(params) -> OptState:
        device = tree_leaves(params)[0].device
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            inner={"m": tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)},
        )

    def _leaf_update(lr_t):
        def upd(p, g, m):
            m = momentum * m + g.to(torch.float32)
            return (p.to(torch.float32) - lr_t * m).to(p.dtype), m

        return upd

    @torch.no_grad()
    def update(grads, state: OptState, params):
        step = state.step + 1
        flat = tree_map(_leaf_update(sched(step)), params, grads,
                        state.inner["m"])
        return (tree_map(lambda t: t[0], flat),
                OptState(step=step,
                         inner={"m": tree_map(lambda t: t[1], flat)}))

    @torch.no_grad()
    def guarded_in_place(grads, state: OptState, params, ok):
        """``update`` where ``ok`` holds, else nothing, in place."""
        step = state.step + 1
        upd = _leaf_update(sched(step))
        for leaf in zip(tree_leaves(params), tree_leaves(grads),
                        tree_leaves(state.inner["m"])):
            for p, g, m in leaf_slices(*leaf):
                new_p, new_m = upd(p, g, m)
                _write_where(ok, new_p, p)
                _write_where(ok, new_m, m)
        return params, OptState(step=torch.where(ok, step, state.step),
                                inner=state.inner)

    update.guarded_in_place = guarded_in_place
    return init, update


def make_optimizer(name: str, lr, **kwargs):
    """``(init, update)`` of the named optimizer: ``adamw``,
    ``adafactor`` or ``sgd`` (SGD with momentum)."""
    if name == "adamw":
        return adamw(lr, **kwargs)
    if name == "adafactor":
        return adafactor(lr, **kwargs)
    if name == "sgd":
        return sgd_momentum(lr, **kwargs)
    raise KeyError(name)
