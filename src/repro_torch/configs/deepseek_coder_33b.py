"""deepseek-coder-33b — dense llama-arch LM [arXiv:2401.14196; hf].

62L, d_model=7168, 56 heads (GQA kv=8, head_dim=128), d_ff=19200,
vocab=32256. Full attention → ``long_500k`` is a documented skip
(DESIGN.md §5). SCE replaces the vocab-CE LM head.

Port of ``repro/configs/deepseek_coder_33b.py`` (own copy).
"""
from repro_torch.configs.common import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig


def make_config(shape_name: str = "train_4k") -> TransformerConfig:
    return TransformerConfig(
        vocab=32256,
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        rope_theta=100000.0,
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
        d_ff=128,
        tie_embeddings=False,
        dtype="float32",
        remat=False,
    )


ARCH = register(
    ArchSpec(
        name="deepseek-coder-33b",
        family="lm",
        paper_ref="arXiv:2401.14196",
        make_config=make_config,
        make_smoke_config=make_smoke_config,
        shapes=lm_shapes(
            long_ctx_skip=(
                "pure full-attention arch: 500k-token decode is "
                "quadratic-KV; skipped per task spec (DESIGN.md §5)"
            )
        ),
        optimizer="adamw",
        train_loss="sce",
        eval_protocol="token-rank",
        dtype="bfloat16",
        fsdp=True,
        microbatches={"train_4k": 16},
        sce_bucket_size_y=512,
    )
)
