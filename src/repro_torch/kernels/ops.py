"""Device dispatch for the kernels (port of the ``mips_topk`` and
``sce_gather_loss`` entries of ``repro/kernels/ops.py``).

A tensor on the CPU takes the kernel's plain version (``ref.py``); a
CUDA tensor launches the hand-written kernel or raises. There is no
fallback from the card to the plain version: a kernel that cannot run
is an error, never a silent detour.
"""
from __future__ import annotations

from repro_torch.kernels import mips_topk as _mips_topk
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sce_prefetch as _sce_prefetch


def _device_kind(op: str, *tensors) -> str:
    """``"cpu"`` or ``"cuda"`` when every tensor lies there; raises on a
    mix or on another device type."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"cuda"}:
        return kinds.pop()
    raise ValueError(
        f"{op} runs on the CPU or a CUDA device; got tensors on "
        f"{sorted(str(t.device) for t in tensors)}"
    )


def mips_topk(q, y, k: int, *, valid=None, id_offset: int = 0):
    """Per-row top-``k`` of ``q @ yᵀ`` → ``(vals (n_q, k) f32, ids
    (n_q, k) int32)``; ``k`` clamped to ``C``, ties to the lower id,
    ``ID_PAD`` on starved slots. See ``kernels/mips_topk.py``."""
    if _device_kind("mips_topk", q, y) == "cpu":
        return _ref.mips_topk_ref(q, y, k, valid=valid, id_offset=id_offset)
    return _mips_topk.mips_topk(q, y, k, valid=valid, id_offset=id_offset)


def sce_gather_loss(x_b, y, idx_y, tgt_b, cand_ids, pos_logit, *,
                    logit_softcap=None):
    """In-bucket SCE losses (n_b, b_x) with the candidate rows
    ``y[idx_y]`` gathered inside the kernel; differentiable in ``x_b``,
    ``y`` and ``pos_logit``. ``pos_logit`` arrives already capped;
    ``logit_softcap`` caps the in-bucket logits. See
    ``kernels/sce_prefetch.py``."""
    args = (x_b, y, idx_y, tgt_b, cand_ids, pos_logit)
    if _device_kind("sce_gather_loss", *args) == "cpu":
        return _ref.sce_gather_loss_ref(*args, logit_softcap)
    return _sce_prefetch.sce_gather_loss(*args, logit_softcap=logit_softcap)
