"""Arch/shape registry (port of ``repro/configs/common.py``, own copy).

Each ``configs/<id>.py`` registers one :class:`ArchSpec`: the published
configuration, its input shapes, a reduced smoke configuration and the
training policy the train step reads (loss, optimizer, dtype,
microbatching, SCE candidate bucket size).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

_REGISTRY: Dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval
    dims: Mapping[str, int]
    skip: Optional[str] = None  # reason string for documented skips


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str  # lm | seqrec | gnn | recsys
    paper_ref: str
    make_config: Callable[[str], Any]  # shape name -> full model config
    make_smoke_config: Callable[[], Any]  # reduced config for CPU tests
    shapes: Tuple[ShapeSpec, ...]
    optimizer: str = "adamw"
    train_loss: str = "sce"
    dtype: str = "float32"
    fsdp: bool = False
    # gradient-accumulation factor per shape name (1 = none)
    microbatches: Mapping[str, int] = dataclasses.field(default_factory=dict)
    # dtype of the microbatch gradient accumulator
    accum_dtype: str = "float32"
    sce_bucket_size_y: int = 512
    # in-loop evaluation protocol ("leave-one-out" for seqrec,
    # "token-rank" for lm)
    eval_protocol: Optional[str] = None
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name!r}")


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


_ARCH_MODULES = ["deepseek_coder_33b", "yi_6b", "gemma2_2b", "kimi_k2",
                 "granite_moe", "bert4rec", "sasrec_sce", "dcn_v2",
                 "dlrm_rm2", "xdeepfm", "schnet"]


def _load_all() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str) -> ArchSpec:
    if name not in _REGISTRY:  # one arch module may be imported already
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    _load_all()
    return tuple(_REGISTRY)


# ---------------------------------------------------------------------------
# The four LM shapes (shared by the LM archs)
# ---------------------------------------------------------------------------
def lm_shapes(*, long_ctx_skip: Optional[str]) -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
        ShapeSpec(
            "prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}
        ),
        ShapeSpec(
            "decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}
        ),
        ShapeSpec(
            "long_500k",
            "decode",
            {"seq_len": 524288, "global_batch": 1},
            skip=long_ctx_skip,
        ),
    )


# ---------------------------------------------------------------------------
# The recsys shapes (BERT4Rec's and the CTR models')
# ---------------------------------------------------------------------------
def recsys_shapes() -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_batch", "train", {"batch": 65536}),
        ShapeSpec("serve_p99", "serve", {"batch": 512}),
        ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
        ShapeSpec(
            "retrieval_cand",
            "retrieval",
            {"batch": 1, "n_candidates": 1_000_000},
        ),
    )
