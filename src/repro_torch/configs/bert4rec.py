"""bert4rec — the bidirectional sequential recommender [arXiv:1904.06690]
(port of ``repro/configs/bert4rec.py``).

embed_dim 64, 2 blocks, 2 heads, sequence length 200, and a catalog of
10⁶ items: the SCE paper's target regime, where full masked-item CE would
need a ``(B·200) × 10⁶`` logit tensor. Encoder-only, so no decode; its
shapes are the recsys set (train, online and bulk serving, retrieval).
"""
from repro_torch.configs.common import ArchSpec, recsys_shapes, register
from repro_torch.models import bert4rec as b4r

N_ITEMS = 1_000_000


def make_config(shape_name: str = "train_batch"):
    return b4r.make_config(
        n_items=N_ITEMS, max_len=200, d_model=64, n_layers=2, n_heads=2
    )


def make_smoke_config():
    return b4r.make_config(
        n_items=500, max_len=32, d_model=32, n_layers=2, n_heads=2
    )


ARCH = register(
    ArchSpec(
        name="bert4rec",
        family="seqrec",
        paper_ref="arXiv:1904.06690",
        make_config=make_config,
        make_smoke_config=make_smoke_config,
        shapes=recsys_shapes(),
        optimizer="adamw",
        train_loss="sce",
        eval_protocol="leave-one-out",
        dtype="float32",
        microbatches={"train_batch": 8},
        sce_bucket_size_y=512,
        notes="native SCE application: masked-item CE over a 1M catalog",
    )
)
