"""sasrec-sce — the SCE paper's own backbone (port of
``repro/configs/sasrec_sce.py``): SASRec with 2 layers, d=64, 2 heads,
L=200, at the paper's Gowalla catalog of 173,511 items (173,520 rows
with the shard-even padding)."""
from repro_torch.configs.common import ArchSpec, ShapeSpec, register
from repro_torch.models.sasrec import SeqRecConfig

N_ITEMS = 173_511  # Gowalla (paper Table 1)


def make_config(shape_name: str = "train_paper") -> SeqRecConfig:
    return SeqRecConfig(
        n_items=N_ITEMS,
        max_len=200,
        d_model=64,
        n_layers=2,
        n_heads=2,
        dropout=0.2,
        causal=True,
    )


def make_smoke_config() -> SeqRecConfig:
    return SeqRecConfig(
        n_items=500, max_len=32, d_model=32, n_layers=2, n_heads=2
    )


ARCH = register(
    ArchSpec(
        name="sasrec-sce",
        family="seqrec",
        paper_ref="arXiv:2409.18721 (this paper); backbone ICDM'18 SASRec",
        make_config=make_config,
        make_smoke_config=make_smoke_config,
        shapes=(
            ShapeSpec(
                "train_paper", "train", {"batch": 128, "seq_len": 200}
            ),
            ShapeSpec("serve_p99", "serve", {"batch": 512}),
            ShapeSpec(
                "retrieval_cand",
                "retrieval",
                {"batch": 1, "n_candidates": N_ITEMS},
            ),
        ),
        optimizer="adamw",
        train_loss="sce",
        eval_protocol="leave-one-out",
        dtype="float32",
        sce_bucket_size_y=256,
    )
)
