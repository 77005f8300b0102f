"""dcn-v2 — CTR model with full-rank cross layers [arXiv:2008.13535]
(port of ``repro/configs/dcn_v2.py``).

n_dense=13, n_sparse=26, embed_dim=16, 3 cross layers, MLP 1024-1024-512.
Criteo-profile vocab sizes (a few 10M-row hot fields + a long small
tail) so the embedding tables dominate memory and row-sharding over
``model`` matters. SCE inapplicable (binary click label) — DESIGN.md §5.
"""
from repro_torch.configs.common import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import DCNv2Config

# Criteo-1TB-profile field cardinalities (26 fields, 31,548,984 rows in
# all; the reference's comment says ~49.5M).
VOCAB_SIZES = (
    10_000_000, 8_000_000, 5_000_000, 4_000_000, 2_000_000, 1_000_000,
    500_000, 500_000, 250_000, 100_000, 100_000, 50_000, 20_000,
    10_000, 10_000, 5_000, 2_000, 1_000, 500, 200, 100, 100, 50, 20, 10, 4,
)


def make_config(shape_name: str = "train_batch") -> DCNv2Config:
    return DCNv2Config(
        n_dense=13,
        vocab_sizes=VOCAB_SIZES,
        embed_dim=16,
        n_cross_layers=3,
        mlp_sizes=(1024, 1024, 512),
    )


def make_smoke_config() -> DCNv2Config:
    return DCNv2Config(
        n_dense=13,
        vocab_sizes=(100, 50, 20),
        embed_dim=8,
        n_cross_layers=2,
        mlp_sizes=(32, 16),
    )


ARCH = register(
    ArchSpec(
        name="dcn-v2",
        family="recsys",
        paper_ref="arXiv:2008.13535",
        make_config=make_config,
        make_smoke_config=make_smoke_config,
        shapes=recsys_shapes(),
        optimizer="adamw",
        train_loss="bce_click",
        dtype="float32",
        notes="SCE inapplicable (binary click); see DESIGN.md §5",
    )
)
