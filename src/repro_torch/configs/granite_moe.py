"""granite-moe-3b-a800m — small MoE LM
[hf:ibm-granite/granite-3.0-1b-a400m-base pattern, scaled per assignment].

32L, d_model=1536, 24 heads (GQA kv=8, head_dim=64), per-expert d_ff=512,
40 experts top-8, vocab=49155. ~3B total / ~0.8B active.
Full attention → ``long_500k`` skip. 40 experts over a 16-way model axis
shard unevenly — GSPMD pads to 48; noted in DESIGN.md §4.

Port of ``repro/configs/granite_moe.py`` (own copy).
"""
from repro_torch.configs.common import ArchSpec, lm_shapes, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def make_config(shape_name: str = "train_4k") -> TransformerConfig:
    return TransformerConfig(
        vocab=49155,
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        rope_theta=10000.0,
        tie_embeddings=True,
        moe=MoEConfig(
            n_experts=40, top_k=8, d_ff=512, capacity_factor=1.25
        ),
        dtype="bfloat16",
        remat=True,
    )


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        vocab=512,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        tie_embeddings=True,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=32),
        dtype="float32",
        remat=False,
    )


ARCH = register(
    ArchSpec(
        name="granite-moe-3b-a800m",
        family="lm",
        paper_ref="hf:ibm-granite/granite-3.0-1b-a400m-base",
        make_config=make_config,
        make_smoke_config=make_smoke_config,
        shapes=lm_shapes(
            long_ctx_skip=(
                "pure full-attention arch: 500k-token decode skipped "
                "per task spec (DESIGN.md §5)"
            )
        ),
        optimizer="adamw",
        train_loss="sce",
        eval_protocol="token-rank",
        dtype="bfloat16",
        fsdp=False,
        microbatches={"train_4k": 8},
        sce_bucket_size_y=512,
    )
)
