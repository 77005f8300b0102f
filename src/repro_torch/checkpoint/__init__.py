"""Fault-tolerant checkpoints of the port (``checkpoint/manager.py``)."""
from repro_torch.checkpoint.manager import (
    CheckpointCorruptError,
    CheckpointManager,
)

__all__ = ["CheckpointManager", "CheckpointCorruptError"]
