"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100 (Hopper, sm_90a).

The JAX/Pallas package ``repro`` is the reference; this package mirrors
its module names (``kernels/``, ``models/``, ``eval/``, ``launch/``,
``data/``, ``configs/``) so each port has an obvious counterpart. It
imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``; what it needs from there it keeps as its own copy.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (the CPU tests do). With no device given and no CUDA
available it raises: it never carries on silently on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, or the
    explicit ``device``. Raises when no device is given and CUDA is not
    available. On a CUDA device f32 matmuls and convolutions are pinned
    to full f32 (TF32 off), so the port's scores keep f32 precision."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def take_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]``: the rows of ``table`` at an integer ``index`` of
    any shape → ``index.shape + table.shape[1:]``.

    On the CPU it gathers with ``torch.index_select``, whose backward sums
    the cotangents of duplicate rows with ``index_add_`` in a fixed
    order. The backward of advanced indexing (``index_put_`` with
    ``accumulate=True``) adds them with parallel atomics on the CPU once
    the gradient has 32,768 elements or more, so two runs of one training
    step could differ in their last bits under load. On a CUDA device it
    is advanced indexing, as before (its backward sorts the indices)."""
    if table.device.type != "cpu":
        return table[index.long()]
    flat = torch.index_select(table, 0, index.reshape(-1).long())
    return flat.reshape(*index.shape, *table.shape[1:])
