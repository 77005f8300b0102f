"""SchNet (Schütt et al. 2017, arXiv:1706.08566) — continuous-filter
convolutional GNN for molecular property regression (port of
``repro/models/schnet.py``).

Message passing is a row gather (``index_select``, the reference's
``jnp.take``) and a scatter-add into the receivers (``index_add``, the
reference's ``segment_sum``); edges are a flat ``(2, E)`` index tensor
``[senders, receivers]``, and batched small graphs are flattened with a
``graph_ids`` segment vector. The reference runs no Pallas kernel here,
and the port adds none. On a CUDA device ``index_add`` adds with atomics,
so two runs may differ in their last bits; on the CPU it adds in a fixed
order.

Parameters are a plain dict in the reference's layout: the interaction
blocks' weights stacked on a leading ``(n_interactions, …)`` axis,
matmul weights ``(d_in, d_out)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.models.layers import dense_init

LOG2 = math.log(2.0)


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    d_feat: int = 128  # input node-feature width (dataset dependent)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        d, r = self.d_hidden, self.n_rbf
        per_inter = d * d * 3 + r * d + d * d + 3 * d  # in/filter-mlp/out
        return (
            self.d_feat * d
            + self.n_interactions * per_inter
            + d * (d // 2)
            + (d // 2)
            + (d // 2) * 1
            + 1
        )


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``softplus(x) − log 2`` with the reference's softplus,
    ``logaddexp(x, 0)`` (``F.softplus`` returns ``x`` itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device)) - LOG2


def init_params(cfg: SchNetConfig, *, seed: int = 0, device=None):
    """Random parameters from ``seed`` (a CPU ``torch.Generator``, so the
    same seed gives the same weights on every device), on ``device``:
    ``cuda`` unless given (raises without CUDA)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    kw = dict(dtype=cfg.torch_dtype, device=device)
    d, r, n = cfg.d_hidden, cfg.n_rbf, cfg.n_interactions

    def stack(shape):
        return torch.stack([dense_init(gen, shape, **kw) for _ in range(n)])

    return {
        "embed": dense_init(gen, (cfg.d_feat, d), **kw),
        "interactions": {
            "w_in": stack((d, d)),  # atom-wise before the cfconv
            "w_filter1": stack((r, d)),  # the filter-generating MLP
            "w_filter2": stack((d, d)),
            "w_out1": stack((d, d)),  # atom-wise after the cfconv
            "b_filter1": torch.zeros(n, d, **kw),
            "b_filter2": torch.zeros(n, d, **kw),
            "b_out1": torch.zeros(n, d, **kw),
        },
        "head_w1": dense_init(gen, (d, d // 2), **kw),
        "head_b1": torch.zeros(d // 2, **kw),
        "head_w2": dense_init(gen, (d // 2, 1), **kw),
        "head_b2": torch.zeros(1, **kw),
    }


def rbf_centers(cfg: SchNetConfig, device=None):
    """The Gaussians' centres and width, ``(centers (n_rbf,), gamma)`` in
    f32, as the reference's compiled ``jnp.linspace(0, cutoff, n_rbf)``
    gives them bit for bit: ``i · (cutoff / (n_rbf − 1))`` in f32 (XLA
    folds linspace's ``stop · (i / div)`` so), the last centre ``cutoff``
    itself; ``gamma = 1 / (c₁ − c₀)²``. At the published config gamma ≈
    894, so one ulp of a centre would move ``exp(−γ(d − c)²)`` by about
    1e-4 relative."""
    f32 = dict(dtype=torch.float32, device=device)
    div = cfg.n_rbf - 1
    stop = torch.tensor(cfg.cutoff, **f32)
    delta = stop / torch.tensor(float(div), **f32)
    centers = torch.cat([torch.arange(div, **f32) * delta, stop[None]])
    gamma = 1.0 / (centers[1] - centers[0]) ** 2
    return centers, gamma


def rbf_expand(dist: torch.Tensor, cfg: SchNetConfig) -> torch.Tensor:
    """Gaussian radial basis on [0, cutoff] with ``n_rbf`` centres →
    ``(E, n_rbf)``."""
    centers, gamma = rbf_centers(cfg, dist.device)
    return torch.exp(-gamma * torch.square(dist[:, None] - centers[None, :]))


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Smooth envelope, so messages vanish at the cutoff radius."""
    return 0.5 * (torch.cos(math.pi * torch.clamp(dist / cutoff, 0.0, 1.0))
                  + 1.0)


def node_energies(params, cfg: SchNetConfig, node_feats, positions,
                  edge_index, edge_valid: Optional[torch.Tensor] = None):
    """The interaction stack and the per-node energy head: node_feats
    ``(N, d_feat)``, positions ``(N, 3)``, edge_index ``(2, E)`` →
    ``(energies (N,), node embeddings (N, d))``. ``edge_valid`` ``(E,)``
    zeroes the messages of padded edges through the envelope."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    x = node_feats @ params["embed"]  # (N, d)

    # Edge geometry, once for every interaction.
    diff = (torch.index_select(positions, 0, src)
            - torch.index_select(positions, 0, dst))
    dist = torch.sqrt(torch.square(diff).sum(dim=-1) + 1e-12)
    rbf = rbf_expand(dist, cfg)  # (E, n_rbf)
    envelope = cosine_cutoff(dist, cfg.cutoff)[:, None]
    if edge_valid is not None:
        envelope = envelope * edge_valid[:, None].to(envelope.dtype)

    inter = params["interactions"]
    for i in range(cfg.n_interactions):
        ip = {k: v[i] for k, v in inter.items()}
        h = x @ ip["w_in"]
        w = shifted_softplus(rbf @ ip["w_filter1"] + ip["b_filter1"])
        w = shifted_softplus(w @ ip["w_filter2"] + ip["b_filter2"])
        msg = torch.index_select(h, 0, src) * (w * envelope)  # (E, d)
        agg = torch.zeros_like(h).index_add(0, dst, msg)
        x = x + shifted_softplus(agg @ ip["w_out1"] + ip["b_out1"])

    e = shifted_softplus(x @ params["head_w1"] + params["head_b1"])
    e = (e @ params["head_w2"] + params["head_b2"])[:, 0]  # (N,)
    return e, x


def forward(params, cfg: SchNetConfig, node_feats, positions, edge_index,
            graph_ids: Optional[torch.Tensor] = None, n_graphs: int = 1,
            edge_valid: Optional[torch.Tensor] = None):
    """→ ``(per-graph energy (n_graphs,), node embeddings (N, d))``: the
    node energies summed by ``graph_ids`` (one graph without them)."""
    e, x = node_energies(params, cfg, node_feats, positions, edge_index,
                         edge_valid)
    if graph_ids is None:
        graph_ids = torch.zeros(node_feats.shape[0], dtype=torch.long,
                                device=e.device)
    energy = torch.zeros(n_graphs, dtype=e.dtype, device=e.device).index_add(
        0, graph_ids.long(), e)
    return energy, x


def mse_loss(params, cfg: SchNetConfig, batch):
    """batch: ``node_feats``, ``positions``, ``edge_index``, ``graph_ids``,
    ``n_graphs``, ``targets`` ``(n_graphs,)``, optionally a
    ``graph_valid`` mask."""
    energy, _ = forward(params, cfg, batch["node_feats"], batch["positions"],
                        batch["edge_index"], batch.get("graph_ids"),
                        batch["n_graphs"])
    err = torch.square(energy - batch["targets"])
    if "graph_valid" in batch:
        w = batch["graph_valid"].to(err.dtype)
        return (err * w).sum() / torch.clamp(w.sum(), min=1.0)
    return err.mean()
