"""Optimizers and schedules of the port (``optimizers.py``)."""
from repro_torch.optim.optimizers import (
    OptState,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
    make_optimizer,
)

__all__ = [
    "OptState",
    "adamw",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "linear_warmup_cosine",
    "make_optimizer",
]
