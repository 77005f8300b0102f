"""yi-6b — dense llama-arch LM with GQA [arXiv:2403.04652; hf].

32L, d_model=4096, 32 heads (GQA kv=4, head_dim=128), d_ff=11008,
vocab=64000. Full attention → ``long_500k`` documented skip.

Port of ``repro/configs/yi_6b.py`` (own copy).
"""
from repro_torch.configs.common import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig


def make_config(shape_name: str = "train_4k") -> TransformerConfig:
    return TransformerConfig(
        vocab=64000,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        rope_theta=5000000.0,
        tie_embeddings=False,
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
        d_ff=160,
        tie_embeddings=False,
        dtype="float32",
        remat=False,
    )


ARCH = register(
    ArchSpec(
        name="yi-6b",
        family="lm",
        paper_ref="arXiv:2403.04652",
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
        fsdp=True,
        microbatches={"train_4k": 4},
        sce_bucket_size_y=512,
    )
)
