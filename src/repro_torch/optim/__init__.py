"""Optimizers and schedules of the port (``optimizers.py``) and int8
error-feedback gradient compression (``compression.py``)."""
from repro_torch.optim.compression import (
    ErrorFeedbackState,
    compress_int8,
    compressed_gradient_transform,
    decompress_int8,
    init_error_feedback,
    with_error_feedback_compression,
)
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
    "ErrorFeedbackState",
    "OptState",
    "adafactor",
    "adamw",
    "clip_by_global_norm",
    "compress_int8",
    "compressed_gradient_transform",
    "cosine_schedule",
    "decompress_int8",
    "global_norm",
    "init_error_feedback",
    "linear_warmup_cosine",
    "make_optimizer",
    "sgd_momentum",
    "with_error_feedback_compression",
]
