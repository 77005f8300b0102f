"""Device dispatch for the kernels (port of the ``mips_topk``,
``sce_gather_loss``, ``sce_gather_plse``, ``eval_fused``,
``eval_tgt_gather``, ``fused_lse``, ``fused_ce_loss`` and
``linear_ce_loss`` entries of ``repro/kernels/ops.py``).

A tensor on the CPU takes the kernel's plain version (``ref.py``); a
CUDA tensor launches the hand-written kernel or raises. There is no
fallback from the card to the plain version: a kernel that cannot run
is an error, never a silent detour.
"""
from __future__ import annotations

from repro_torch.kernels import eval_fused as _eval_fused
from repro_torch.kernels import fused_ce as _fused_ce
from repro_torch.kernels import linear_sce as _linear_sce
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


def sce_gather_plse(x_b, y, idx_y, tgt_b, cand_ids, *, logit_softcap=None):
    """Partial in-bucket logsumexp (n_b, b_x) over the candidate rows
    ``y[idx_y]`` gathered inside the kernel, with no positive term —
    the distributed merge's building block. Candidates with a negative
    ``cand_ids`` (padding, or rows another shard owns) are masked; a row
    with none left is ``NEG_INF``. Differentiable in ``x_b`` and ``y``.
    See ``kernels/sce_prefetch.py``."""
    args = (x_b, y, idx_y, tgt_b, cand_ids)
    if _device_kind("sce_gather_plse", *args) == "cpu":
        return _ref.sce_gather_plse_ref(*args, logit_softcap)
    return _sce_prefetch.sce_gather_plse(*args, logit_softcap=logit_softcap)


def eval_fused(x, y, targets, k: int, *, tgt_scores=None, block_c: int = 512,
               c_lo: int = 0, c_hi=None, id_offset: int = 0,
               logit_softcap=None, with_lse: bool = False):
    """One catalog sweep: top-``k``, the target's rank counts and
    (``with_lse``) the online LSE → ``(vals (B, k), ids (B, k), gt (B,),
    eq (B,), tgt (B,), m, s)``, ``m``/``s`` ``None`` unless ``with_lse``.
    ``block_c`` is the plain version's chunk; the kernel plans its own
    split. See ``kernels/eval_fused.py``."""
    kw = dict(tgt_scores=tgt_scores, c_lo=c_lo, c_hi=c_hi,
              id_offset=id_offset, logit_softcap=logit_softcap,
              with_lse=with_lse)
    if _device_kind("eval_fused", x, y, targets) == "cpu":
        return _ref.eval_fused_ref(x, y, targets, k, chunk=block_c, **kw)
    return _eval_fused.eval_fused(x, y, targets, k, **kw)


def eval_tgt_gather(x, y, targets, *, block_c: int = 512,
                    id_offset: int = 0):
    """Each row's target score, bit for bit the column :func:`eval_fused`
    sweeps (0 where the target is outside ``y``'s id range) → (B,) f32.
    ``block_c`` is the plain version's chunk, to match its sweep."""
    if _device_kind("eval_tgt_gather", x, y, targets) == "cpu":
        return _ref.eval_tgt_gather_ref(x, y, targets, chunk=block_c,
                                        id_offset=id_offset)
    return _eval_fused.eval_tgt_gather(x, y, targets, id_offset=id_offset)


def fused_lse(x, y, *, block_c: int = 512):
    """Streamed full-catalog logsumexp (N,), differentiable in ``x`` and
    ``y``. ``block_c`` is the plain version's catalog chunk; the kernel
    plans its own tiles. See ``kernels/fused_ce.py``."""
    if _device_kind("fused_lse", x, y) == "cpu":
        return _ref.fused_lse_ref(x, y, chunk=block_c)
    return _fused_ce.fused_lse(x, y)


def fused_ce_loss(x, y, targets, *, block_c: int = 512):
    """Streamed per-position full CE ``lse − x·y[targets]`` (N,), the
    positive gathered outside the sweep."""
    if _device_kind("fused_ce_loss", x, y, targets) == "cpu":
        return _ref.fused_ce_loss_ref(x, y, targets, chunk=block_c)
    return _fused_ce.fused_ce_loss(x, y, targets)


def linear_ce_loss(x, w, targets, *, logit_softcap=None, block_c: int = 512):
    """Fused linear CE: per-position full-catalog CE (N,) from ``(N, d)``
    hidden states and the ``(C, d)`` table, the target's logit plucked
    inside the sweep and ``logit_softcap`` applied in the tile; the
    ``(N, C)`` logits never exist on the card, forward or backward.
    ``block_c`` is the plain version's catalog chunk. See
    ``kernels/linear_sce.py``."""
    if _device_kind("linear_ce_loss", x, w, targets) == "cpu":
        return _ref.linear_ce_loss_ref(x, w, targets,
                                       logit_softcap=logit_softcap,
                                       chunk=block_c)
    return _linear_sce.linear_ce_loss(x, w, targets,
                                      logit_softcap=logit_softcap)
