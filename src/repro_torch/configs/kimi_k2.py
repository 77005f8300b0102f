"""kimi-k2-1t-a32b — trillion-parameter MoE LM [arXiv:2501.kimi2;
unverified paper-table config].

61L, d_model=7168, 64 heads (GQA kv=8, head_dim=112), per-expert
d_ff=2048, 384 experts top-8 (+1 shared), vocab=163840.
~1.03T total / ~32B active params. Full attention → ``long_500k`` skip.

Scale policy: Adafactor (factored second moments — AdamW's 8 TB of f32
moments cannot exist), bf16 params, EP over ``model`` + FSDP over
``data`` for expert weights, microbatched train step.

Port of ``repro/configs/kimi_k2.py`` (own copy).
"""
from repro_torch.configs.common import ArchSpec, lm_shapes, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def make_config(shape_name: str = "train_4k") -> TransformerConfig:
    return TransformerConfig(
        vocab=163840,
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=112,
        d_ff=2048,  # unused (MoE supplies per-expert d_ff)
        rope_theta=50000.0,
        tie_embeddings=False,
        moe=MoEConfig(
            n_experts=384,
            top_k=8,
            d_ff=2048,
            capacity_factor=1.25,
            n_shared_experts=1,
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
        d_ff=64,
        tie_embeddings=False,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, n_shared_experts=1),
        dtype="float32",
        remat=False,
    )


ARCH = register(
    ArchSpec(
        name="kimi-k2-1t-a32b",
        family="lm",
        paper_ref="arXiv:2501.kimi2 (unverified)",
        make_config=make_config,
        make_smoke_config=make_smoke_config,
        shapes=lm_shapes(
            long_ctx_skip=(
                "pure full-attention arch: 500k-token decode skipped "
                "per task spec (DESIGN.md §5)"
            )
        ),
        optimizer="adafactor",
        train_loss="sce",
        eval_protocol="token-rank",
        dtype="bfloat16",
        fsdp=True,
        microbatches={"train_4k": 16},
        accum_dtype="bfloat16",
        sce_bucket_size_y=1024,
    )
)
