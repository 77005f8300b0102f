"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): GShard-style
token-choice top-k routing with per-sequence capacity, in plain PyTorch.

Per batch row, with capacity ``C = int(L · top_k · cf / n_experts)``
over the real experts:
  1. router logits (f32) → softmax → the top-k experts of each token,
     lower expert id first among equal probabilities (the reference's
     ``lax.top_k``), their probabilities renormalised over the k;
  2. each (token, k) assignment's rank within its expert's queue, in
     the order ``token · top_k + k`` (a stable sort by expert id and an
     exclusive cumsum of the expert counts, as the reference);
  3. assignments of rank ≥ C are dropped: the reference scatters them
     out of bounds (``mode="drop"``); here they are masked and written
     to a spare slot that is cut away;
  4. tokens gathered into an ``(E_pad, C, d)`` buffer (an empty slot
     reads a zero row), the expert SwiGLU as three batched products over
     the experts, and each token's ≤ top_k expert outputs weighted by
     their probabilities and summed back.

Step 4's combine gathers each token's contributions and adds them in
ascending expert id — the order in which the reference's scatter-add
meets them — in f32, rounded once to the model's type. The reference
adds them in the model's type (ROADMAP "Known deviations": in bf16 the
two differ by bf16 rounding; in f32 they are the same sums). Nothing in
the combine is atomic, so a rerun, and the recompute of a checkpointed
layer, repeat the same bits.

The dispatch buffers are allocated at ``n_experts_padded``; phantom
experts get no router column and no tokens. The Switch aux loss
(arXiv:2101.03961 §2.2) is ``n_experts · Σ_e frac_tokens_e ·
mean_prob_e`` per row (kept assignments only), averaged over rows and
scaled by ``aux_loss_weight``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    n_shared_experts: int = 0  # always-on experts (DeepSeek/Kimi style)
    # Expert weights padded so the expert axis divides a 16-way model
    # axis (granite's 40 experts pad to 48). Phantom experts get no
    # router outputs and no tokens.
    expert_pad_multiple: int = 16

    @property
    def n_experts_padded(self) -> int:
        m = self.expert_pad_multiple
        return -(-self.n_experts // m) * m

    def capacity(self, seq_len: int) -> int:
        """Slots an expert holds per sequence row of ``seq_len`` tokens."""
        return max(1, int(seq_len * self.top_k * self.capacity_factor
                          / self.n_experts))


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, *,
             dtype=torch.float32, device=None):
    """One layer's MoE weights: ``router`` (d, n_experts) f32, the expert
    SwiGLU ``w_gate`` / ``w_up`` (E_pad, d, f) and ``w_down`` (E_pad, f,
    d) in ``dtype``, and with shared experts ``shared`` (their SwiGLU,
    width ``f · n_shared_experts``). Drawn by ``gen`` with the
    reference's ``dense_init`` rule (its fan-in is a shape's first axis,
    the expert axis for the stacked experts)."""
    e, f = cfg.n_experts_padded, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    params = {
        "router": dense_init(gen, (d_model, cfg.n_experts),
                             dtype=torch.float32, device=device),
        "w_gate": dense_init(gen, (e, d_model, f), **kw),
        "w_up": dense_init(gen, (e, d_model, f), **kw),
        "w_down": dense_init(gen, (e, f, d_model), **kw),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        params["shared"] = {
            "w_gate": dense_init(gen, (d_model, fs), **kw),
            "w_up": dense_init(gen, (d_model, fs), **kw),
            "w_down": dense_init(gen, (fs, d_model), **kw),
        }
    return params


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
def route(probs: torch.Tensor, top_k: int):
    """(…, E) f32 probabilities → the top-k ``(p, ids)``, values
    descending and the lower id first among equal values (a stable
    descending sort: ``torch.topk`` promises no tie order on CUDA),
    ``p`` renormalised over the k."""
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_e


def rank_within_expert(expert_ids: torch.Tensor,
                       n_experts: int) -> torch.Tensor:
    """(B, S) expert ids → (B, S) int64: each assignment's rank in its
    expert's queue, in assignment order (the reference's
    ``_rank_within_expert``, batched over rows)."""
    b, s = expert_ids.shape
    order = torch.argsort(expert_ids, dim=-1, stable=True)
    sorted_e = torch.gather(expert_ids, -1, order)
    counts = torch.zeros(b, n_experts, dtype=torch.int64,
                         device=expert_ids.device)
    counts.scatter_add_(-1, expert_ids, torch.ones_like(expert_ids))
    starts = torch.cumsum(counts, -1) - counts  # exclusive cumsum
    pos = torch.arange(s, device=expert_ids.device).expand(b, s)
    ranks_sorted = pos - torch.gather(starts, -1, sorted_e)
    return torch.empty_like(ranks_sorted).scatter_(-1, order, ranks_sorted)


@dataclasses.dataclass
class Dispatch:
    """One routed batch (B rows of L tokens, S = L · top_k assignments,
    assignment ``t · top_k + j`` the token's j-th choice): ``expert`` /
    ``rank`` / ``keep`` / ``weight`` (its renormalised probability)
    (B, S), ``dispatch_idx`` (B, E_pad, C) int64 token index per slot
    (L: empty), and ``slot`` (B, S) the flat slot ``e · C + rank`` of a
    kept assignment, ``E_pad · C`` of a dropped one."""
    expert: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    weight: torch.Tensor
    dispatch_idx: torch.Tensor
    slot: torch.Tensor


def dispatch(probs: torch.Tensor, cfg: MoEConfig,
             capacity: int) -> Dispatch:
    """Route (B, L, E) f32 probabilities (the reference's
    ``_dispatch_one_row`` over every row at once, without the token
    gather)."""
    b, l, _ = probs.shape
    k, e = cfg.top_k, cfg.n_experts_padded
    top_p, top_e = route(probs, k)
    flat_e = top_e.reshape(b, l * k)
    flat_p = top_p.reshape(b, l * k)
    rank = rank_within_expert(flat_e, cfg.n_experts)
    keep = rank < capacity
    spare = e * capacity  # dropped assignments land here, then are cut
    slot = torch.where(keep, flat_e * capacity + rank, spare)
    tok = torch.arange(l, device=probs.device).repeat_interleave(k)
    idx = torch.full((b, spare + 1), l, dtype=torch.int64,
                     device=probs.device)
    idx.scatter_(-1, slot, tok.expand(b, -1))
    return Dispatch(expert=flat_e, rank=rank, keep=keep, weight=flat_p,
                    dispatch_idx=idx[:, :spare].reshape(b, e, capacity),
                    slot=slot)


# Dropped-assignment counts of the MoE layers' forwards, when on.
_DROPS: Optional[List[Tuple[torch.Tensor, int]]] = None


@contextlib.contextmanager
def count_drops():
    """``with count_drops() as drops:`` — every :func:`apply_moe` call
    inside appends ``(dropped, assignments)`` — a 0-d int64 device
    tensor and an int — to the list ``drops``: one pair per layer a
    forward runs (the recompute of a checkpointed layer inside the
    backward routes the same tokens again and is not counted)."""
    global _DROPS
    before, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = before


def apply_moe(params, x, cfg: MoEConfig, activation=F.silu):
    """x (B, L, d) → ``(y (B, L, d), aux)``, ``aux`` a 0-d f32 tensor
    (``aux_loss_weight`` times the rows' mean Switch loss)."""
    b, l, d = x.shape
    e_pad = cfg.n_experts_padded
    capacity = cfg.capacity(l)
    logits = torch.einsum("bld,de->ble", x.to(torch.float32),
                          params["router"])
    probs = torch.softmax(logits, dim=-1)
    r = dispatch(probs, cfg, capacity)
    # graph task -1: not inside a backward, where a checkpointed layer's
    # recompute routes the same tokens a second time
    if _DROPS is not None and torch._C._current_graph_task_id() == -1:
        _DROPS.append(((~r.keep).sum(), r.keep.numel()))

    # gather tokens; an empty slot (index L) reads the zero row
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    rows = torch.arange(b, device=x.device)[:, None]
    x_e = x_pad[rows, r.dispatch_idx.reshape(b, -1)].reshape(
        b, e_pad, capacity, d)
    gate = activation(torch.matmul(x_e, params["w_gate"]))
    up = torch.matmul(x_e, params["w_up"])
    y_e = torch.matmul(gate * up, params["w_down"])  # (B, E_pad, C, d)

    # combine: each token's kept outputs, ascending expert id, f32 sum
    k = cfg.top_k
    slot = r.slot.reshape(b, l, k)
    w = torch.where(r.keep, r.weight, 0.0).reshape(b, l, k)
    order = torch.argsort(r.expert.reshape(b, l, k), dim=-1, stable=True)
    slot, w = torch.gather(slot, -1, order), torch.gather(w, -1, order)
    y_flat = torch.cat([y_e.reshape(b, e_pad * capacity, d),
                        y_e.new_zeros(b, 1, d)], dim=1)
    y = None
    for j in range(k):
        part = y_flat[rows, slot[..., j]].to(torch.float32) * w[..., j, None]
        y = part if y is None else y + part
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        sp = params["shared"]
        g = activation(x @ sp["w_gate"])
        y = y + (g * (x @ sp["w_up"])) @ sp["w_down"]

    # the Switch aux loss over the real experts, kept assignments only
    frac = torch.zeros(b, cfg.n_experts, dtype=torch.float32,
                       device=x.device)
    frac.scatter_add_(-1, r.expert, r.keep.to(torch.float32))
    frac = frac / (l * k)
    aux = cfg.n_experts * torch.sum(frac * probs.mean(dim=1), dim=-1)
    return y.to(x.dtype), cfg.aux_loss_weight * aux.mean()
