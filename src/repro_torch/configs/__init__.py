"""Arch registry of the port (every arch of the reference)."""
from repro_torch.configs.common import ArchSpec, ShapeSpec, get_arch, register

__all__ = ["ArchSpec", "ShapeSpec", "get_arch", "register"]
