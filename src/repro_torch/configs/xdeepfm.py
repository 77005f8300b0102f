"""xdeepfm — CTR model with Compressed Interaction Network
[arXiv:1803.05170] (port of ``repro/configs/xdeepfm.py``).

n_sparse=39, embed_dim=10, CIN layers 200-200-200, DNN 400-400.
SCE inapplicable (binary click) — DESIGN.md §5.
"""
from repro_torch.configs.common import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import XDeepFMConfig

# 39 fields, Criteo-with-extra-context profile (19,977,764 rows in all).
VOCAB_SIZES = (
    5_000_000, 4_000_000, 3_000_000, 2_000_000, 2_000_000, 1_000_000,
    1_000_000, 500_000, 500_000, 250_000, 250_000, 100_000, 100_000,
    100_000, 50_000, 50_000, 20_000, 20_000, 10_000, 10_000, 5_000,
    5_000, 2_000, 2_000, 1_000, 1_000, 500, 500, 200, 200, 100, 100,
    50, 50, 20, 20, 10, 10, 4,
)


def make_config(shape_name: str = "train_batch") -> XDeepFMConfig:
    return XDeepFMConfig(
        vocab_sizes=VOCAB_SIZES,
        embed_dim=10,
        cin_layers=(200, 200, 200),
        mlp_sizes=(400, 400),
    )


def make_smoke_config() -> XDeepFMConfig:
    return XDeepFMConfig(
        vocab_sizes=(100, 50, 20, 10),
        embed_dim=4,
        cin_layers=(8, 8),
        mlp_sizes=(16,),
    )


ARCH = register(
    ArchSpec(
        name="xdeepfm",
        family="recsys",
        paper_ref="arXiv:1803.05170",
        make_config=make_config,
        make_smoke_config=make_smoke_config,
        shapes=recsys_shapes(),
        optimizer="adamw",
        train_loss="bce_click",
        dtype="float32",
        notes="SCE inapplicable (binary click); see DESIGN.md §5",
    )
)
