"""Arch/shape registry (port of ``repro/configs/common.py``, own copy).

Each ``configs/<id>.py`` registers one :class:`ArchSpec`: the published
configuration, its input shapes, a reduced smoke configuration and the
training policy the train step reads (loss, optimizer, dtype,
microbatching, SCE candidate bucket size). The port registers only the
archs it has ported.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

_REGISTRY: Dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | serve | retrieval
    dims: Mapping[str, int]


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
    # gradient-accumulation factor per shape name (1 = none)
    microbatches: Mapping[str, int] = dataclasses.field(default_factory=dict)
    # dtype of the microbatch gradient accumulator
    accum_dtype: str = "float32"
    sce_bucket_size_y: int = 512
    # in-loop evaluation protocol ("leave-one-out" for seqrec); not ported
    eval_protocol: Optional[str] = None

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name!r}")


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


_ARCH_MODULES = ["sasrec_sce"]


def _load_all() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str) -> ArchSpec:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
