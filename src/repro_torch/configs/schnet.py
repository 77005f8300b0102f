"""schnet — continuous-filter GNN [arXiv:1706.08566; paper] (port of
``repro/configs/schnet.py``).

n_interactions=3, d_hidden=64, rbf=300, cutoff=10. Four graph regimes:
full-batch small (Cora-sized), sampled minibatch (Reddit-sized, fanout
15-10), full-batch large (ogbn-products-sized), and batched molecules.

SCE is inapplicable (energy regression, no categorical output) — the arch
runs WITHOUT the paper's technique and exercises the GNN substrate
(segment_sum message passing, neighbor sampler, edge sharding).
DESIGN.md §5. ogb_products (2 × 61,859,140 directed edges: its ``(E,
300)`` RBF features alone are 138 GiB in f32) needs the edges sharded
over several cards.
"""
from repro_torch.configs.common import ArchSpec, ShapeSpec, register
from repro_torch.models.schnet import SchNetConfig

# Per-shape node-feature width (dataset-determined: Cora=1433, Reddit=602,
# ogbn-products=100, synthetic molecules=128).
SHAPE_DIMS = {
    "full_graph_sm": dict(
        n_nodes=2708, n_edges=10556, d_feat=1433, kind_note="full-batch"
    ),
    "minibatch_lg": dict(
        n_nodes=232_965,
        n_edges=114_615_892,
        batch_nodes=1024,
        fanouts=(15, 10),
        d_feat=602,
    ),
    "ogb_products": dict(
        n_nodes=2_449_029, n_edges=61_859_140, d_feat=100
    ),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=128),
}


def make_config(shape_name: str = "molecule") -> SchNetConfig:
    d_feat = SHAPE_DIMS[shape_name]["d_feat"]
    return SchNetConfig(
        n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0, d_feat=d_feat
    )


def make_smoke_config() -> SchNetConfig:
    return SchNetConfig(
        n_interactions=2, d_hidden=16, n_rbf=20, cutoff=5.0, d_feat=8
    )


ARCH = register(
    ArchSpec(
        name="schnet",
        family="gnn",
        paper_ref="arXiv:1706.08566",
        make_config=make_config,
        make_smoke_config=make_smoke_config,
        shapes=(
            ShapeSpec(
                "full_graph_sm",
                "train",
                {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433},
            ),
            ShapeSpec(
                "minibatch_lg",
                "train_sampled",
                {
                    "n_nodes": 232_965,
                    "n_edges": 114_615_892,
                    "batch_nodes": 1024,
                    "fanout0": 15,
                    "fanout1": 10,
                    "d_feat": 602,
                },
            ),
            ShapeSpec(
                "ogb_products",
                "train",
                {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100},
            ),
            ShapeSpec(
                "molecule",
                "train",
                {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 128},
            ),
        ),
        optimizer="adamw",
        train_loss="mse",
        dtype="float32",
        notes="SCE inapplicable (regression); see DESIGN.md §5",
    )
)
