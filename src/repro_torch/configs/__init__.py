"""Arch registry of the port (only the archs ported so far)."""
from repro_torch.configs.common import ArchSpec, ShapeSpec, get_arch, register

__all__ = ["ArchSpec", "ShapeSpec", "get_arch", "register"]
