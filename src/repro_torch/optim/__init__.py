"""Optimizers and schedules of the port (``optimizers.py``)."""
from repro_torch.optim.optimizers import (
    OptState,
    adafactor,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
    make_optimizer,
    sgd_momentum,
)

__all__ = [
    "OptState",
    "adafactor",
    "adamw",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "linear_warmup_cosine",
    "make_optimizer",
    "sgd_momentum",
]
