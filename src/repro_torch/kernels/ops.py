"""Device dispatch for the kernels (port of the ``mips_topk`` entry of
``repro/kernels/ops.py``).

A tensor on the CPU takes the kernel's plain version (``ref.py``); a
CUDA tensor launches the hand-written kernel or raises. There is no
fallback from the card to the plain version: a kernel that cannot run
is an error, never a silent detour.
"""
from __future__ import annotations

from repro_torch.kernels import mips_topk as _mips_topk
from repro_torch.kernels import ref as _ref


def mips_topk(q, y, k: int, *, valid=None, id_offset: int = 0):
    """Per-row top-``k`` of ``q @ yᵀ`` → ``(vals (n_q, k) f32, ids
    (n_q, k) int32)``; ``k`` clamped to ``C``, ties to the lower id,
    ``ID_PAD`` on starved slots. See ``kernels/mips_topk.py``."""
    if q.device.type == "cpu" and y.device.type == "cpu":
        return _ref.mips_topk_ref(q, y, k, valid=valid, id_offset=id_offset)
    if q.is_cuda and y.is_cuda:
        return _mips_topk.mips_topk(q, y, k, valid=valid, id_offset=id_offset)
    raise ValueError(
        f"mips_topk runs on the CPU or a CUDA device; got q on {q.device}, "
        f"y on {y.device}"
    )
