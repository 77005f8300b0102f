"""Losses and metrics of the port: the SCE loss (``sce.py``), the loss
registry SCE is compared against (``losses.py``) and the dense evaluation
oracle (``metrics.py``)."""
from repro_torch.core.losses import loss_peak_elements, make_loss
from repro_torch.core.sce import (
    SCEConfig,
    aggregate_bucket_losses,
    full_ce_memory_bytes,
    make_bucket_centers,
    sce_loss,
    sce_loss_memory_bytes,
    select_buckets,
)

__all__ = [
    "SCEConfig",
    "sce_loss",
    "make_bucket_centers",
    "select_buckets",
    "aggregate_bucket_losses",
    "sce_loss_memory_bytes",
    "full_ce_memory_bytes",
    "make_loss",
    "loss_peak_elements",
]
