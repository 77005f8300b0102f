"""dlrm-rm2 — DLRM with the RM2 sizing [arXiv:1906.00091]
(port of ``repro/configs/dlrm_rm2.py``).

n_dense=13, n_sparse=26, embed_dim=64, bottom MLP 13-512-256-64,
top MLP 512-512-256-1, pairwise-dot interaction. The 64-wide tables make
this the most embedding-bound recsys arch (2.56 GB a 10M-row field in
f32; 35,048,984 rows in all).
SCE inapplicable (binary click) — DESIGN.md §5.
"""
from repro_torch.configs.common import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import DLRMConfig

VOCAB_SIZES = (
    10_000_000, 10_000_000, 5_000_000, 5_000_000, 2_000_000, 1_000_000,
    1_000_000, 500_000, 250_000, 100_000, 100_000, 50_000, 20_000,
    10_000, 10_000, 5_000, 2_000, 1_000, 500, 200, 100, 100, 50, 20, 10, 4,
)


def make_config(shape_name: str = "train_batch") -> DLRMConfig:
    return DLRMConfig(
        n_dense=13,
        vocab_sizes=VOCAB_SIZES,
        embed_dim=64,
        bot_mlp=(512, 256, 64),
        top_mlp=(512, 512, 256, 1),
    )


def make_smoke_config() -> DLRMConfig:
    return DLRMConfig(
        n_dense=13,
        vocab_sizes=(100, 50, 20),
        embed_dim=8,
        bot_mlp=(16, 8),
        top_mlp=(16, 8, 1),
    )


ARCH = register(
    ArchSpec(
        name="dlrm-rm2",
        family="recsys",
        paper_ref="arXiv:1906.00091",
        make_config=make_config,
        make_smoke_config=make_smoke_config,
        shapes=recsys_shapes(),
        optimizer="adamw",
        train_loss="bce_click",
        dtype="float32",
        notes="SCE inapplicable (binary click); see DESIGN.md §5",
    )
)
