"""Conformance canaries: each hand-written kernel against its plain
version, on the device it will run on (port of
``repro/kernels/guard/conformance.py``).

Every kernel group carries the reference's small registry of
ADVERSARIAL cases, with the same names, the same numpy inputs (``_SEED +
salt``) and the same tolerances:

  * tie-heavy duplicate catalog rows (top-k tie order: the lower global
    id wins),
  * ragged tails (a catalog or bucket that is not a whole number of the
    kernel's 64-row tiles),
  * starvation ``C < k`` and a masked catalog row with an ``id_offset``,
  * duplicate rows in one bucket's gather (``sce_gather``'s dY adds them
    into one catalog row),
  * softcap-active logit scales (the in-tile ``cap·tanh`` path).

Each canary resolves the kernel entry at CALL time (``_kernel``), so a
monkeypatched, broken kernel is what runs — the fault drills rely on it.
For a CUDA device that entry is the wrapper of the hand-written kernel
(``kernels/<module>.py``); the yardstick is the port's own plain version
(``kernels/ref.py``) on the same device. On the CPU there is no kernel:
the entry is the ``ops`` function, which takes the plain version there,
so a CPU verdict only shows that the plain versions run and agree with
themselves. A canary that raises or disagrees fails; the verdict per
``(device, kernel group)`` is memoized and consulted by every CUDA
dispatch of ``kernels/ops.py`` (``guard.kernel_enabled``).

**The two bitwise canaries do not carry across frameworks.** On the TPU
``tgt_gather_bitwise`` and ``two_pass_ties`` compare the Pallas kernel
with ``jnp`` at ``atol=0``: a same-shape product folds the same way in
both. The port's CUDA ``fmaf`` chain and torch's matmul fold
differently, so here the kernel is held against the plain version at
``_ATOL`` / ``_RTOL``, and the bitwise check is kernel against kernel:
``eval_tgt_gather`` must equal, bit for bit, the target column that
``eval_fused`` sweeps (read back from its top-k at ``k = C``), and
``eval_tgt_scores`` the column that ``eval_topk`` sweeps (every row
whose target is in the window has ``eq >= 1`` when its own threshold is
fed back).

Canaries run in the caller's thread, on its device and current stream,
under ``torch.enable_grad()`` and outside inference mode: a kernel's
first dispatch may come inside autograd's backward (grad mode off) or a
serve step (inference mode), and the ``plse_grad`` and
``duplicate_row_rmw`` canaries need autograd. Their inputs come from
numpy, so the caller's torch RNG is never touched.
"""
from __future__ import annotations

import dataclasses
import importlib
import threading
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_ATOL = 2e-4
_RTOL = 2e-4

_SEED = 0xCA9A  # canary inputs are deterministic per case


class KernelConformanceError(RuntimeError):
    """A kernel's conformance canaries failed on this device: its CUDA
    dispatch raises this under policies ``warn`` and ``strict``."""

    def __init__(self, kernel: str, device_key, failures):
        msg = (f"[guard.conformance] kernel {kernel!r} FAILED conformance "
               f"on {device_key}: " + "; ".join(failures))
        super().__init__(msg)
        self.kernel = kernel
        self.failures = tuple(failures)


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Outcome of one kernel group's canaries on one device."""

    kernel: str
    backend: str  # "cuda" or "cpu"
    device: str  # e.g. "cuda:0"
    n_pass: int
    n_fail: int
    failures: Tuple[str, ...]
    # (wrapper, launches) the canaries made: what a verdict costs the card
    launches: Tuple[Tuple[str, int], ...] = ()

    @property
    def passed(self) -> bool:
        return self.n_fail == 0

    def to_dict(self) -> Dict:
        return {
            "kernel": self.kernel,
            "backend": self.backend,
            "device": self.device,
            "passed": self.passed,
            "n_pass": self.n_pass,
            "n_fail": self.n_fail,
            "failures": list(self.failures),
            "launches": dict(self.launches),
        }


_CANARIES: Dict[str, List[Tuple[str, Callable[[torch.device], None]]]] = {}
_VERDICTS: Dict[Tuple[str, str], Verdict] = {}
_LOCK = threading.RLock()


def _canary(kernel: str, name: str):
    def register(fn):
        _CANARIES.setdefault(kernel, []).append((name, fn))
        return fn

    return register


def kernels() -> Tuple[str, ...]:
    """Kernel groups with a registered canary suite."""
    return tuple(sorted(_CANARIES))


def _device(device) -> torch.device:
    """The verdict's device, with a CUDA index made explicit (the
    current device's when none is given)."""
    if device is None:
        from repro_torch import resolve_device

        device = resolve_device(None)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# Every kernel wrapper with a ``.launches`` counter, by module.
_WRAPPERS = {
    "mips_topk": ("mips_topk",),
    "sce_prefetch": ("sce_gather_fwd", "sce_gather_dx", "sce_gather_dy",
                     "sce_gather_plse_fwd", "sce_gather_plse_dx",
                     "sce_gather_plse_dy"),
    "sce_bucket": ("sce_bucket_fwd", "sce_bucket_dx", "sce_bucket_dy",
                   "sce_bucket_plse_fwd"),
    "eval_fused": ("eval_fused", "eval_tgt_gather"),
    "eval_topk": ("eval_topk", "eval_tgt_scores"),
    "linear_sce": ("linear_ce_fwd", "linear_ce_dx", "linear_ce_dw"),
    "fused_ce": ("fused_lse_fwd", "fused_lse_dx", "fused_lse_dy"),
}


def _wrappers():
    for module, names in _WRAPPERS.items():
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        for name in names:
            yield name, getattr(mod, name)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by wrapper name (0 for a
    wrapper that was replaced by one without a counter)."""
    return {name: getattr(fn, "launches", 0) for name, fn in _wrappers()}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counter to 0 (and
    ``mips_topk.launches_by_k`` to empty): where a run that reads the
    counts starts."""
    for name, fn in _wrappers():
        fn.launches = 0
        if hasattr(fn, "launches_by_k"):
            fn.launches_by_k.clear()


def clear_verdicts(kernel: Optional[str] = None) -> None:
    """Drop memoized verdicts (all, or one group's) — the hook of the
    fault drills and of a readiness refresh after a fix."""
    with _LOCK:
        if kernel is None:
            _VERDICTS.clear()
        else:
            for key in [k for k in _VERDICTS if k[1] == kernel]:
                del _VERDICTS[key]


def _run_canary(fn, dev: torch.device) -> Optional[BaseException]:
    """Run one canary; its exception (a crash is a verdict too), or
    ``None`` on a pass."""
    try:
        with torch.inference_mode(False), torch.enable_grad():
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    fn(dev)
            else:
                fn(dev)
    except Exception as e:  # noqa: BLE001 — recorded in the verdict
        return e
    return None


def verdict_for(kernel: str, *, device=None) -> Verdict:
    """Memoized canary verdict for ``kernel`` on ``device`` (default: the
    current CUDA device; raises without one). The first call per
    ``(device, kernel)`` runs the canaries; later calls are a lookup."""
    if kernel not in _CANARIES:
        raise KeyError(
            f"no conformance canaries registered for kernel {kernel!r} "
            f"(known: {', '.join(kernels())})")
    dev = _device(device)
    key = (str(dev), kernel)
    with _LOCK:
        v = _VERDICTS.get(key)
        if v is not None:
            return v
        n_pass, failures = 0, []
        before = launch_counts()
        for name, fn in _CANARIES[kernel]:
            err = _run_canary(fn, dev)
            if err is None:
                n_pass += 1
            else:
                failures.append(f"{name}: {type(err).__name__}: {err}")
        after = launch_counts()
        v = Verdict(kernel=kernel, backend=dev.type, device=str(dev),
                    n_pass=n_pass, n_fail=len(failures),
                    failures=tuple(failures),
                    launches=tuple((w, after[w] - before[w])
                                   for w in sorted(after)
                                   if after[w] != before[w]))
        _VERDICTS[key] = v
        return v


def run_conformance(which: Optional[Tuple[str, ...]] = None, *,
                    device=None, refresh: bool = False) -> Dict[str, Verdict]:
    """Run (or fetch memoized) canary suites → ``{kernel: Verdict}``: the
    startup/CI entry (``chip_smoke.py``'s conformance phase; the server
    gates on ``mips_topk``'s)."""
    names = tuple(which) if which else kernels()
    if refresh:
        for k in names:
            clear_verdicts(k)
    return {k: verdict_for(k, device=device) for k in names}


def verdict_table() -> List[Dict]:
    """JSON-ready snapshot of every memoized verdict (the server's
    ``health()``)."""
    with _LOCK:
        return [v.to_dict() for _, v in sorted(_VERDICTS.items())]


# ---------------------------------------------------------------------------
# Canary inputs and checks
# ---------------------------------------------------------------------------
def _rng(salt: int) -> np.random.Generator:
    return np.random.default_rng(_SEED + salt)


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _assert_close(name: str, got, want, atol=_ATOL, rtol=_RTOL):
    got, want = _np(got), _np(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != plain "
                             f"{want.shape}")
    if not np.allclose(got, want, atol=atol, rtol=rtol, equal_nan=True):
        err = float(np.max(np.abs(got.astype(np.float64)
                                  - want.astype(np.float64))))
        raise AssertionError(f"{name}: max abs err {err:.3e} vs the plain "
                             f"version (atol={atol})")


def _assert_ids(name: str, got, want):
    got, want = _np(got), _np(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{name}: id/tie-order mismatch vs the plain "
                             f"version")


def _sce_arrays(salt: int, n_b=2, b_x=5, b_y=7, d=8, c=16, softcap=None):
    """The reference's adversarial SCE bucket inputs as numpy arrays:
    b_x / b_y that are not whole tiles, a padding slot (cand −1), a
    duplicated candidate row and a forced target collision →
    ``(x_b, y, idx_y, tgt_b, cand_ids)``."""
    r = _rng(salt)
    scale = 4.0 if softcap else 1.0  # softcap-active logit magnitudes
    x_b = (r.normal(size=(n_b, b_x, d)) * scale).astype(np.float32)
    y = r.normal(size=(c, d)).astype(np.float32)
    tgt_b = r.integers(0, c, size=(n_b, b_x)).astype(np.int32)
    idx = r.integers(0, c, size=(n_b, b_y))
    idx[:, 1] = idx[:, 0]  # duplicate row inside one bucket
    cand_ids = idx.astype(np.int32)
    cand_ids[:, -1] = -1  # padding slot
    cand_ids[0, 2] = int(tgt_b[0, 0])  # forced target collision
    idx_y = np.maximum(cand_ids, 0).astype(np.int32)
    return x_b, y, idx_y, tgt_b, cand_ids


def _sce_inputs(salt: int, dev, n_b=2, b_x=5, b_y=7, d=8, c=16,
                softcap=None):
    """:func:`_sce_arrays` on ``dev``, with the (capped) positive logits
    and the gathered candidates → ``(x_b, y, y_b, idx_y, tgt_b,
    cand_ids, pos)``."""
    x_b, y, idx_y, tgt_b, cand_ids = (
        _t(a, dev) for a in _sce_arrays(salt, n_b, b_x, b_y, d, c, softcap))
    pos = torch.einsum("nxd,nxd->nx", x_b, y[tgt_b.long()])
    if softcap:
        pos = softcap * torch.tanh(pos / softcap)
    y_b = y[idx_y.long()]
    return x_b, y, y_b, idx_y, tgt_b, cand_ids, pos


def _kernel(module: str, name: str, *tensors):
    """The entry a canary vets, resolved at call time so a monkeypatched
    kernel is what runs: ``kernels/<module>.py``'s wrapper when the
    tensors take the CUDA route of ``ops``, else the ``ops`` entry (the
    plain version on the CPU)."""
    from repro_torch.kernels import ops

    if ops._device_kind(name, *tensors) == "cuda":
        return getattr(importlib.import_module(
            f"repro_torch.kernels.{module}"), name)
    return getattr(ops, name)


def _ref():
    from repro_torch.kernels import ref

    return ref


# -- sce_bucket --------------------------------------------------------------
@_canary("sce_bucket", "tail_collisions_softcap")
def _sce_bucket_loss_canary(dev):
    ref = _ref()
    for softcap in (None, 5.0):
        x_b, _, y_b, _, tgt_b, cand_ids, pos = _sce_inputs(
            1, dev, softcap=softcap)
        got = _kernel("sce_bucket", "sce_bucket_loss", x_b)(
            x_b, y_b, tgt_b, cand_ids, pos, logit_softcap=softcap)
        want = ref.sce_bucket_loss_ref(x_b, y_b, tgt_b, cand_ids, pos,
                                       softcap)
        _assert_close(f"loss(softcap={softcap})", got, want)


@_canary("sce_bucket", "plse_grad")
def _sce_bucket_plse_canary(dev):
    ref = _ref()
    x_b, _, y_b, _, tgt_b, cand_ids, _ = _sce_inputs(2, dev)
    got = _kernel("sce_bucket", "sce_bucket_plse", x_b)(
        x_b, y_b, tgt_b, cand_ids, logit_softcap=None)
    want = ref.sce_bucket_plse_ref(x_b, y_b, tgt_b, cand_ids, None)
    _assert_close("plse", got, want)
    zeros = torch.zeros(tgt_b.shape, dtype=torch.float32, device=dev)

    def grads(loss_fn):
        xb = x_b.detach().clone().requires_grad_(True)
        yb = y_b.detach().clone().requires_grad_(True)
        return torch.autograd.grad(loss_fn(xb, yb).sum(), (xb, yb))

    k_loss = _kernel("sce_bucket", "sce_bucket_loss", x_b)
    got = grads(lambda xb, yb: k_loss(xb, yb, tgt_b, cand_ids, zeros,
                                      logit_softcap=None))
    want = grads(lambda xb, yb: ref.sce_bucket_loss_ref(
        xb, yb, tgt_b, cand_ids, zeros, None))
    _assert_close("dX", got[0], want[0], atol=1e-3, rtol=1e-3)
    # dY too (the reference's canary checks dX alone): the port's dY
    # writes each bucket's rows instead of adding, and the guard vets
    # every launch it gates.
    _assert_close("dY", got[1], want[1], atol=1e-3, rtol=1e-3)


# -- sce_gather (the candidate gather inside the kernel, dY into C rows) -----
@_canary("sce_gather", "duplicate_row_rmw")
def _sce_gather_canary(dev):
    ref = _ref()
    x_b, y, _, idx_y, tgt_b, cand_ids, pos = _sce_inputs(3, dev)
    k_loss = _kernel("sce_prefetch", "sce_gather_loss", x_b)
    got = k_loss(x_b, y, idx_y, tgt_b, cand_ids, pos, logit_softcap=None)
    want = ref.sce_bucket_loss_ref(x_b, y[idx_y.long()], tgt_b, cand_ids,
                                   pos, None)
    _assert_close("gather_loss", got, want)

    # dY added straight into (C, d) through duplicated gather indices
    # must equal the gathered plain version's scatter-add.
    def grad_y(loss_fn):
        yy = y.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(yy).sum(), yy)
        return g

    got = grad_y(lambda yy: k_loss(x_b, yy, idx_y, tgt_b, cand_ids, pos,
                                   logit_softcap=None))
    want = grad_y(lambda yy: ref.sce_bucket_loss_ref(
        x_b, yy[idx_y.long()], tgt_b, cand_ids, pos, None))
    _assert_close("dY_rmw", got, want, atol=1e-3, rtol=1e-3)


@_canary("sce_gather", "plse_tail")
def _sce_gather_plse_canary(dev):
    ref = _ref()
    x_b, y, y_b, idx_y, tgt_b, cand_ids, _ = _sce_inputs(4, dev, b_y=9)
    got = _kernel("sce_prefetch", "sce_gather_plse", x_b)(
        x_b, y, idx_y, tgt_b, cand_ids, logit_softcap=None)
    want = ref.sce_bucket_plse_ref(x_b, y_b, tgt_b, cand_ids, None)
    _assert_close("gather_plse", got, want)


# -- mips_topk ---------------------------------------------------------------
@_canary("mips_topk", "tie_duplicates_tail")
def _mips_ties_canary(dev):
    ref = _ref()
    r = _rng(10)
    base = r.normal(size=(5, 8)).astype(np.float32)
    # Tie-heavy catalog: every row twice (C = 10, a ragged tile); ties
    # must go to the LOWER global id on both paths.
    y = _t(np.repeat(base, 2, axis=0), dev)
    q = _t(r.normal(size=(6, 8)).astype(np.float32), dev)
    got_v, got_i = _kernel("mips_topk", "mips_topk", q, y)(q, y, 4)
    want_v, want_i = ref.mips_topk_ref(q, y, 4)
    _assert_ids("topk_ids", got_i, want_i)
    _assert_close("topk_vals", got_v, want_v)


@_canary("mips_topk", "starvation_valid_offset")
def _mips_starved_canary(dev):
    ref = _ref()
    r = _rng(11)
    q = _t(r.normal(size=(3, 8)).astype(np.float32), dev)
    y = _t(r.normal(size=(3, 8)).astype(np.float32), dev)
    valid = torch.tensor([True, False, True], device=dev)
    # k = 8 > C = 3 (clamped), a masked row and a nonzero id base.
    got_v, got_i = _kernel("mips_topk", "mips_topk", q, y)(
        q, y, 8, valid=valid, id_offset=7)
    want_v, want_i = ref.mips_topk_ref(q, y, 8, valid=valid, id_offset=7)
    _assert_ids("starved_ids", got_i, want_i)
    _assert_close("starved_vals", got_v, want_v)


# -- fused_ce ----------------------------------------------------------------
@_canary("fused_ce", "lse_and_loss_tail")
def _fused_ce_canary(dev):
    ref = _ref()
    r = _rng(20)
    x = _t(r.normal(size=(6, 8)).astype(np.float32), dev)
    y = _t(r.normal(size=(11, 8)).astype(np.float32), dev)  # ragged tile
    tgt = _t(r.integers(0, 11, size=(6,)).astype(np.int32), dev)
    got = _kernel("fused_ce", "fused_lse", x, y)(x, y)
    _assert_close("fused_lse", got, ref.fused_lse_ref(x, y))
    got = _kernel("fused_ce", "fused_ce_loss", x, y, tgt)(x, y, tgt)
    _assert_close("fused_ce_loss", got, ref.fused_ce_loss_ref(x, y, tgt))


# -- linear_sce --------------------------------------------------------------
@_canary("linear_sce", "softcap_value_and_grads")
def _linear_sce_canary(dev):
    ref = _ref()
    r = _rng(30)
    x = _t(r.normal(size=(6, 8)).astype(np.float32) * 3, dev)
    w = _t(r.normal(size=(13, 8)).astype(np.float32), dev)
    tgt = _t(r.integers(0, 13, size=(6,)).astype(np.int32), dev)
    cap = 4.0  # softcap-active scales
    k_loss = _kernel("linear_sce", "linear_ce_loss", x, w, tgt)

    def value_and_grads(loss_fn):
        xx = x.detach().clone().requires_grad_(True)
        ww = w.detach().clone().requires_grad_(True)
        loss = loss_fn(xx, ww).sum()
        gx, gw = torch.autograd.grad(loss, (xx, ww))
        return loss.detach(), gx, gw

    gl, gdx, gdw = value_and_grads(
        lambda xx, ww: k_loss(xx, ww, tgt, logit_softcap=cap))
    wl, wdx, wdw = value_and_grads(
        lambda xx, ww: ref.linear_ce_loss_ref(xx, ww, tgt,
                                              logit_softcap=cap))
    _assert_close("linear_ce", gl, wl)
    _assert_close("linear_dx", gdx, wdx, atol=1e-3, rtol=1e-3)
    _assert_close("linear_dw", gdw, wdw, atol=1e-3, rtol=1e-3)


# -- eval_fused --------------------------------------------------------------
@_canary("eval_fused", "ties_window_lse")
def _eval_fused_canary(dev):
    ref = _ref()
    r = _rng(40)
    base = r.normal(size=(7, 8)).astype(np.float32)
    y = _t(np.concatenate([base, base[:3]], axis=0), dev)  # C = 10, ties
    x = _t(r.normal(size=(5, 8)).astype(np.float32), dev)
    tgt = _t(r.integers(1, 9, size=(5,)).astype(np.int32), dev)
    kw = dict(c_lo=1, c_hi=9, with_lse=True)
    got = _kernel("eval_fused", "eval_fused", x, y, tgt)(x, y, tgt, 4, **kw)
    want = ref.eval_fused_ref(x, y, tgt, 4, **kw)
    for name, g, w in zip(("vals", "gt", "eq", "tgt", "m", "s"),
                          (got[0],) + tuple(got[2:]),
                          (want[0],) + tuple(want[2:])):
        _assert_close(f"eval_{name}", g, w)
    _assert_ids("eval_ids", got[1], want[1])


def _assert_swept_column(name: str, vals, ids, targets, tgt):
    """Kernel against kernel: each row's target column, read back from a
    top-k that keeps every column, is bit for bit ``tgt``."""
    vals, ids = _np(vals), _np(ids)
    targets, tgt = _np(targets), _np(tgt)
    hit = ids == targets[:, None]
    if not (hit.sum(axis=1) == 1).all():
        raise AssertionError(f"{name}: a target is missing from the sweep")
    swept = vals[hit]
    if not np.array_equal(swept.view(np.int32), tgt.view(np.int32)):
        err = float(np.max(np.abs(swept - tgt)))
        raise AssertionError(f"{name}: not bitwise the swept column "
                             f"(max diff {err:.3e})")


@_canary("eval_fused", "tgt_gather_bitwise")
def _eval_tgt_gather_canary(dev):
    ref = _ref()
    r = _rng(41)
    x = _t(r.normal(size=(5, 8)).astype(np.float32), dev)
    y = _t(r.normal(size=(10, 8)).astype(np.float32), dev)
    tgt = _t(r.integers(0, 10, size=(5,)).astype(np.int32), dev)
    got = _kernel("eval_fused", "eval_tgt_gather", x, y, tgt)(x, y, tgt)
    want = ref.eval_tgt_gather_ref(x, y, tgt)
    _assert_close("tgt_gather", got, want)
    # The threshold must be the very value the sweep computes: eval_fused
    # at k = C keeps every column.
    sweep = _kernel("eval_fused", "eval_fused", x, y, tgt)
    vals, ids = sweep(x, y, tgt, y.shape[0], tgt_scores=got)[:2]
    _assert_swept_column("tgt_gather_vs_sweep", vals, ids, tgt, got)


# -- eval_topk: the deprecated two-pass oracle entries ------------------------
@_canary("eval_topk", "two_pass_ties")
def _eval_topk_canary(dev):
    ref = _ref()
    r = _rng(50)
    base = r.normal(size=(6, 8)).astype(np.float32)
    y = _t(np.concatenate([base, base[:2]], axis=0), dev)  # C = 8, ties
    x = _t(r.normal(size=(4, 8)).astype(np.float32), dev)
    tgt = _t(r.integers(0, 8, size=(4,)).astype(np.int32), dev)
    with warnings.catch_warnings():  # the oracle's own use of the entries
        warnings.simplefilter("ignore", DeprecationWarning)
        ts_got = _kernel("eval_topk", "eval_tgt_scores", x, y, tgt)(x, y,
                                                                     tgt)
        got = _kernel("eval_topk", "eval_topk", x, y, ts_got)(x, y, ts_got, 3)
    plain_scores, plain_topk = ref.eval_tgt_scores_ref, ref.eval_topk_ref
    ts_want = plain_scores(x, y, tgt)
    _assert_close("tgt_scores", ts_got, ts_want)
    want = plain_topk(x, y, ts_want, 3)
    _assert_ids("two_pass_ids", got[1], want[1])
    for name, g, w in zip(("vals", "gt", "eq"), (got[0], got[2], got[3]),
                          (want[0], want[2], want[3])):
        _assert_close(f"two_pass_{name}", g, w)
    # Kernel against kernel: with no self-column rule, eq counts the
    # target's own column only if the threshold is bitwise its score.
    if not (_np(got[3]) >= 1).all():
        raise AssertionError("two_pass_eq: eval_tgt_scores is not bitwise "
                             "the column eval_topk sweeps")
