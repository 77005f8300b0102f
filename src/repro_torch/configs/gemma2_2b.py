"""gemma2-2b — dense LM, alternating local/global attention, logit
softcaps [arXiv:2408.00118; hf].

26L, d_model=2304, 8 heads (GQA kv=4, head_dim=256), d_ff=9216,
vocab=256000 — the largest dense vocab in the pool and therefore the SCE
showcase arch. Runs ``long_500k``: the local(4096-window)/global pattern
keeps half the layers' KV caches at window size, and global layers decode
O(S) over a sequence-sharded cache (DESIGN.md §5).

Port of ``repro/configs/gemma2_2b.py`` (own copy).
"""
from repro_torch.configs.common import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig


def make_config(shape_name: str = "train_4k") -> TransformerConfig:
    return TransformerConfig(
        vocab=256000,
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        rope_theta=10000.0,
        attn_pattern=("local", "global"),
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        use_post_norm=True,
        tie_embeddings=True,
        scale_embeddings=True,
        dtype="bfloat16",
        remat=True,
    )


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        vocab=1024,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        attn_pattern=("local", "global"),
        window=16,
        attn_softcap=50.0,
        final_softcap=30.0,
        use_post_norm=True,
        tie_embeddings=True,
        scale_embeddings=True,
        dtype="float32",
        remat=False,
    )


ARCH = register(
    ArchSpec(
        name="gemma2-2b",
        family="lm",
        paper_ref="arXiv:2408.00118",
        make_config=make_config,
        make_smoke_config=make_smoke_config,
        shapes=lm_shapes(long_ctx_skip=None),  # runs 500k (local/global)
        optimizer="adamw",
        train_loss="sce",
        eval_protocol="token-rank",
        dtype="bfloat16",
        fsdp=False,  # 2.6B replicates fine; TP for the 256k-vocab head
        microbatches={"train_4k": 2},
        sce_bucket_size_y=1024,  # big catalog → larger buckets pay off
        notes="final-logit softcap applied inside the tile on both SCE "
              "paths (kernel + jnp); full-CE baseline via ce_fused_linear",
    )
)
