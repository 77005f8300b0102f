"""The port's kernel guard (``repro_torch.kernels.guard``) and divergence
guard (``repro_torch.launch.elastic``) against the JAX package's, on the
CPU.

* The reference's 11 canaries: each one's kernel-entry calls are recorded
  on both sides (the reference's ``_mod`` and the port's ``_kernel`` patched to
  recorders around the plain versions; JAX's grad tracers unwrapped to
  their primal values): the inputs are equal array for array (the
  positive logits, an ``einsum`` in each framework, within ``1e-6``
  relative), and the port's plain versions on them match ``repro``'s refs
  — float outputs within ``1e-5·max|want|`` plus ``2e-4·|want|``, ids
  exactly. The eval counts (``gt``/``eq``) are not compared with
  ``repro``'s: on jax 0.9.0 its chunked and gathered scores differ by an
  ulp, so its counts can be off by one (ROADMAP queue 3);
  ``test_torch_eval_topk.py`` holds them against a dense f64 oracle.
* Sentinel counts on injected NaN and all-masked rows equal
  ``repro.kernels.guard.sentinels``'.
* ``DivergenceGuard`` gives the reference's verdicts and caps on the same
  loss sequences (spike, NaN, recovery).
* Preflight's rule names, outcomes and its ``ValueError`` subclass.
* Policy drills after ``tests/test_guard.py``, with a monkeypatched
  broken kernel and ``ops._device_kind`` patched to ``"cuda"`` so the
  CUDA route runs here: ``off`` reaches the broken kernel, ``warn`` and
  ``strict`` raise ``KernelConformanceError`` (the port's one deviation:
  the reference degrades under ``warn``); a CPU dispatch consults no
  verdict.
"""
import math
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import Cursor as JaxCursor
from repro.kernels import ref as jref
from repro.kernels.guard import conformance as jconf
from repro.kernels.guard import sentinels as jsent
from repro.launch.elastic import DivergenceGuard as JaxDivergenceGuard
from repro_torch.data import Cursor
from repro_torch.kernels import guard, ops, ref
from repro_torch.kernels import mips_topk as mips_mod
from repro_torch.kernels.guard import conformance as tconf
from repro_torch.kernels.guard.preflight import (
    KNOWN_KERNELS,
    MAX_SMEM,
    PREFLIGHT_RULES,
)
from repro_torch.launch.elastic import DivergenceGuard

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_guard():
    guard.set_policy(None)
    guard.clear_verdicts()
    yield
    guard.set_policy(None)
    guard.clear_verdicts()


# ---------------------------------------------------------------------------
# The canaries: the same inputs, and the plain versions on them
# ---------------------------------------------------------------------------
def _take(y, idx):
    return jnp.take(y, jnp.clip(idx, 0, y.shape[0] - 1).reshape(-1),
                    axis=0).reshape(idx.shape + (y.shape[-1],))


# What each reference kernel entry computes, as ``repro``'s ref at the
# canary's own chunk (so the reference's canaries pass on their recorder).
JAX_PLAIN = {
    "sce_bucket_loss": lambda x_b, y_b, t, c, pos, *a: jref.sce_bucket_loss_ref(
        x_b, y_b, t, c, pos, a[3]),
    "sce_bucket_plse": lambda x_b, y_b, t, c, *a: jref.sce_bucket_plse_ref(
        x_b, y_b, t, c, a[3]),
    "sce_gather_loss": lambda x_b, y, i, t, c, pos, *a:
        jref.sce_bucket_loss_ref(x_b, _take(y, i), t, c, pos, a[3]),
    "sce_gather_plse": lambda x_b, y, i, t, c, *a: jref.sce_bucket_plse_ref(
        x_b, _take(y, i), t, c, a[3]),
    "mips_topk": lambda q, y, k, valid=None, id_offset=0, block_c=512, **kw:
        jref.mips_topk_ref(q, y, k, valid=valid, chunk=block_c,
                           id_offset=id_offset),
    "fused_lse": lambda x, y, bn, bc, *a: jref.fused_lse_ref(x, y),
    "fused_ce_loss": lambda x, y, t, *a: jref.fused_ce_loss_ref(x, y, t),
    "linear_ce_loss": lambda x, w, t, cap, bn, bc, *a:
        jref.linear_ce_loss_ref(x, w, t, logit_softcap=cap, chunk=bc),
    "eval_fused": lambda x, y, t, k, c_lo=0, c_hi=None, with_lse=False,
    block_c=512, **kw: jref.eval_fused_ref(x, y, t, k, chunk=block_c,
                                           c_lo=c_lo, c_hi=c_hi,
                                           with_lse=with_lse),
    "eval_tgt_gather": lambda x, y, t, block_c=512, **kw:
        jref.eval_tgt_gather_ref(x, y, t, chunk=block_c),
    "eval_tgt_scores": lambda x, y, t, block_c=512, **kw:
        jref.eval_tgt_scores_ref(x, y, t, chunk=block_c),
    "eval_topk": lambda x, y, ts, k, block_c=512, **kw:
        jref.eval_topk_ref(x, y, ts, k, chunk=block_c),
}
COUNT_OUTPUTS = {"eval_fused": (2, 3), "eval_topk": (2, 3)}


def _primal(a):
    while hasattr(a, "primal"):
        a = a.primal
    return a


def _is_array(a):
    return isinstance(a, (jax.Array, np.ndarray, torch.Tensor)) or \
        hasattr(a, "primal")


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(_primal(a))


def _recorder(calls, name, fn):
    def call(*args, **kw):
        out = fn(*args, **kw)
        arrays = [_host(a) for a in list(args) + list(kw.values())
                  if _is_array(a)]
        outs = out if isinstance(out, tuple) else (out,)
        calls.setdefault(name, []).append(
            (arrays, [None if o is None else _host(o) for o in outs]))
        return out
    return call


def _record_reference(group, canary, monkeypatch):
    calls = {}

    def mod(module):
        return types.SimpleNamespace(**{
            n: _recorder(calls, n, f) for n, f in JAX_PLAIN.items()})

    monkeypatch.setattr(jconf, "_mod", mod)
    dict(jconf._CANARIES[group])[canary](True)
    return calls


def _record_port(group, canary, monkeypatch):
    calls = {}
    monkeypatch.setattr(
        tconf, "_kernel",
        lambda module, name, *t: _recorder(calls, name, getattr(ops, name)))
    dict(tconf._CANARIES[group])[canary](CPU)
    return calls


CANARIES = [(g, n) for g in sorted(jconf._CANARIES)
            for n, _ in jconf._CANARIES[g]]


# The port's own canaries, after the reference's in their group.
PORT_ONLY = {"mips_topk": ["large_k_select_overflow"]}


def test_the_port_has_the_reference_canaries():
    assert len(CANARIES) == 11
    assert tconf.kernels() == jconf.kernels()
    for g in tconf.kernels():
        assert [n for n, _ in tconf._CANARIES[g]] == \
            [n for n, _ in jconf._CANARIES[g]] + PORT_ONLY.get(g, [])
    assert (tconf._ATOL, tconf._RTOL, tconf._SEED) == \
        (jconf._ATOL, jconf._RTOL, jconf._SEED)


@pytest.mark.parametrize("group,canary", CANARIES,
                         ids=[f"{g}-{n}" for g, n in CANARIES])
def test_canary_inputs_and_plain_versions_match_reference(group, canary,
                                                          monkeypatch):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = _record_reference(group, canary, monkeypatch)
        got = _record_port(group, canary, monkeypatch)
    assert want and set(want) <= set(got)
    for name, jcalls in want.items():
        assert len(got[name]) >= len(jcalls), name
        for (garr, gout), (warr, wout) in zip(got[name], jcalls):
            assert len(garr) == len(warr), name
            for g, w in zip(garr, warr):
                assert g.shape == w.shape and g.dtype.kind == w.dtype.kind
                if w.dtype.kind == "f":
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
                else:
                    np.testing.assert_array_equal(g, w)
            skip = COUNT_OUTPUTS.get(name, ())
            for i, (g, w) in enumerate(zip(gout, wout)):
                if i in skip or w is None:
                    continue
                assert g.shape == w.shape, (name, i)
                if w.dtype.kind == "f":
                    w64 = w.astype(np.float64)
                    tol = 1e-5 * np.abs(w64).max() + 2e-4 * np.abs(w64)
                    assert (np.abs(g - w64) <= tol).all(), (name, i)
                else:
                    np.testing.assert_array_equal(g, w)


def test_canary_input_builder_matches_reference():
    """``_sce_arrays`` draws the reference's ``_sce_inputs`` arrays."""
    for salt, kw in ((1, {}), (1, {"softcap": 5.0}), (4, {"b_y": 9})):
        x_b, y, _, idx_y, tgt_b, cand, pos = jconf._sce_inputs(salt, **kw)
        got = tconf._sce_inputs(salt, CPU, **kw)
        for g, w in zip((got[0], got[1], got[3], got[4], got[5]),
                        (x_b, y, idx_y, tgt_b, cand)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(got[6].numpy(), np.asarray(pos),
                                   rtol=1e-6, atol=1e-6)


def test_all_canaries_pass_on_the_cpu():
    verdicts = guard.run_conformance(device="cpu")
    assert sorted(verdicts) == sorted(guard.KNOWN_KERNELS)
    assert all(v.passed for v in verdicts.values())
    assert sum(v.n_pass for v in verdicts.values()) == 12
    table = guard.verdict_table()
    assert len(table) == 7 and all(r["device"] == "cpu" for r in table)
    # memoized: the same object until cleared
    assert guard.verdict_for("mips_topk", device="cpu") is \
        verdicts["mips_topk"]
    guard.clear_verdicts("mips_topk")
    assert len(guard.verdict_table()) == 6


def test_verdict_for_unknown_kernel_raises():
    with pytest.raises(KeyError):
        guard.verdict_for("nope", device="cpu")


# ---------------------------------------------------------------------------
# Sentinels
# ---------------------------------------------------------------------------
def test_sentinels_match_reference():
    rng = np.random.default_rng(0)
    per_pos = rng.normal(size=(4, 6)).astype(np.float32)
    per_pos[0, 1] = np.nan
    per_pos[2, 3] = np.inf
    lse = rng.normal(size=(4, 6)).astype(np.float32)
    lse[1, :] = -1e30  # all-masked rows
    lse[3, 2] = -1e30 + 5.0
    got = guard.loss_sentinels("sce_bucket", torch.from_numpy(per_pos),
                               torch.from_numpy(lse))
    want = jsent.loss_sentinels("sce_bucket", jnp.asarray(per_pos),
                                jnp.asarray(lse))
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == torch.int32 and got[k].ndim == 0
        assert int(got[k]) == int(want[k]), k
    assert int(got["sce_bucket_nonfinite"]) == 2
    merged = guard.merge_sentinels(got, got, {"x_nonfinite": torch.tensor(1)})
    jmerged = jsent.merge_sentinels(want, want,
                                    {"x_nonfinite": jnp.int32(1)})
    assert {k: int(v) for k, v in merged.items()} == \
        {k: int(v) for k, v in jmerged.items()}
    assert guard.describe_sentinels(merged) == \
        jsent.describe_sentinels(jmerged)
    assert guard.describe_sentinels({"a": torch.tensor(0)}) == ""


def test_kernel_losses_attach_sentinels_like_reference():
    """``ce_chunked`` (no kernel on either side) under the default policy:
    the same counter names and counts as the reference's, on a poisoned
    row; ``ce_fused_linear``'s counter on the port's plain path."""
    from repro.core import losses as jlosses
    from repro_torch.core import losses

    rng = np.random.default_rng(1)
    x = rng.normal(size=(12, 8)).astype(np.float32)
    y = rng.normal(size=(30, 8)).astype(np.float32)
    t = rng.integers(0, 30, 12).astype(np.int32)
    x[3, 0] = np.nan
    _, aux = losses.ce_chunked(torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(t), chunk_size=7)
    _, jaux = jlosses.ce_chunked(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(t), chunk_size=7)
    assert {k: int(v) for k, v in aux["sentinels"].items()} == \
        {k: int(v) for k, v in jaux["sentinels"].items()}
    _, aux = losses.ce_fused_linear(torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(t))
    assert {k: int(v) for k, v in aux["sentinels"].items()} == \
        {"linear_sce_nonfinite": 1}
    guard.set_policy("off")
    assert losses.ce_fused_linear(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(t))[1] == {}


# ---------------------------------------------------------------------------
# The divergence guard
# ---------------------------------------------------------------------------
SEQUENCES = {
    "healthy": [5.0 - 0.1 * i for i in range(20)],
    "spike": [4.0] * 10 + [900.0, 4.0, 4.0],
    "nan": [4.0] * 3 + [math.nan, math.nan, 4.0, math.nan, math.nan,
                        math.nan, 4.0],
    "recovery": [4.0] * 9 + [1e4, 1e4, 3.9, 3.8] + [math.inf] * 3 + [3.7],
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
@pytest.mark.parametrize("max_strikes,factor", [(3, 100.0), (2, 10.0)])
def test_divergence_guard_matches_reference(seq, max_strikes, factor):
    a = DivergenceGuard(max_strikes=max_strikes, cap_factor=factor)
    b = JaxDivergenceGuard(max_strikes=max_strikes, cap_factor=factor)
    for i, loss in enumerate(SEQUENCES[seq]):
        assert a.loss_cap() == b.loss_cap(), i
        skipped = not math.isfinite(loss) or loss > a.loss_cap()
        assert a.observe(loss, skipped=skipped) == \
            b.observe(loss, skipped=skipped), i
        assert (a.strikes, a.rollbacks) == (b.strikes, b.rollbacks)
    assert a.reseed(Cursor(seed=3, step=7)).step == \
        b.reseed(JaxCursor(seed=3, step=7)).step


def test_divergence_guard_cap_warms_up():
    g = DivergenceGuard()
    for i in range(8):
        assert g.loss_cap() == math.inf
        assert g.observe(2.0 + i, skipped=False) == "ok"
    assert g.loss_cap() == 100.0 * 5.5
    assert g.observe(1e9, skipped=False) == "strike"
    assert g.observe(1.0, skipped=True) == "strike"
    assert g.observe(math.nan, skipped=True) == "rollback"
    assert g.rollbacks == 1 and g.loss_cap() == math.inf


# ---------------------------------------------------------------------------
# Preflight
# ---------------------------------------------------------------------------
def test_preflight_rules_and_error_type():
    assert issubclass(guard.KernelPreflightError, ValueError)
    assert set(PREFLIGHT_RULES) >= {
        "unknown_kernel", "positive_dims", "dtype_supported",
        "positive_block", "block_le_dim", "smem_budget"}
    assert "mxu_alignment" not in PREFLIGHT_RULES
    assert KNOWN_KERNELS == (
        "sce_bucket", "sce_gather", "mips_topk", "fused_ce", "linear_sce",
        "eval_fused", "eval_topk")
    cases = [
        (dict(kernel="nope"), "unknown_kernel"),
        (dict(rows=0), "positive_dims"),
        (dict(k=0), "positive_dims"),
        (dict(dtype="float64"), "dtype_supported"),
        (dict(dtype=torch.float16), "dtype_supported"),
        # no group keeps a flat depth cap (linear_sce at d 257 is planned
        # below); mips_topk's deep chain takes k to 1024, the sweeps'
        # lists to 512
        (dict(k=1025), "k_max"),
        (dict(kernel="eval_fused", k=513), "k_max"),
        (dict(smem_bytes=232_449), "smem_budget"),
    ]
    base = dict(kernel="mips_topk", rows=8, cols=100, d=64, k=10,
                dtype=torch.float32)
    for change, rule in cases:
        with pytest.raises(guard.KernelPreflightError) as ei:
            guard.preflight(**{**base, **change})
        assert ei.value.rule == rule
    ok = guard.preflight(**base, smem_bytes=232_448)
    assert ok.repairs == [] and ok.smem_bytes == 232_448
    # bfloat16, the reference's other type, is planned like float32 (the
    # kernels widen it where it lands: the same shared memory)
    bf16 = guard.preflight(**{**base, "dtype": torch.bfloat16},
                           smem_bytes=232_448)
    assert bf16.repairs == [] and bf16.smem_bytes == 232_448
    deep = guard.preflight(**{**base, "kernel": "linear_sce", "d": 257,
                              "k": None}, smem_bytes=229_376)
    assert deep.params["d"] == 257 and deep.repairs == []


def test_preflight_repairs_and_policies():
    pf = guard.preflight("eval_fused", rows=8, cols=100, d=64, k=10,
                         block_cols=0, block_rows=50)
    assert pf.blocks == (8, 100)
    assert [(r.rule, r.silent) for r in pf.repairs] == [
        ("positive_block", False), ("block_le_dim", True)]
    # a fixed point: the repaired request checks clean
    again = guard.preflight("eval_fused", rows=8, cols=100, d=64, k=10,
                            block_rows=pf.blocks[0],
                            block_cols=pf.blocks[1])
    assert again.repairs == []
    kw = dict(rows=8, cols=100, d=64, k=10, block_cols=0)
    with pytest.warns(RuntimeWarning, match="positive_block"):
        assert guard.checked_blocks("eval_fused", **kw) == (None, 100)
    guard.set_policy("strict")
    with pytest.raises(guard.KernelPreflightError) as ei:
        guard.checked_blocks("eval_fused", **kw)
    assert ei.value.rule == "positive_block"
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # silent repairs stay silent
        assert guard.checked_blocks("eval_fused", rows=8, cols=100, d=64,
                                    block_cols=512) == (None, 100)
    guard.set_policy("off")
    assert guard.checked_blocks("eval_fused", rows=8, cols=100, d=999,
                                block_cols=0) == (None, 0)


def test_planned_shared_memory_fits_at_the_kernels_limits():
    from repro_torch.kernels import linear_sce, sce_prefetch

    assert sce_prefetch.planned_smem(256) <= MAX_SMEM
    assert linear_sce.planned_smem(256) <= MAX_SMEM
    for k in (10, 256, 320, 512):
        assert mips_mod.planned_smem(320, 173_520, 256, k, 132) <= \
            MAX_SMEM
    # mips_topk above k = 32: every launch of the threshold, collect and
    # select chain and of its finishing sweep, at the widest d and k and
    # at one row and many (the τ sort's union is largest at few rows)
    for n_q in (1, 320, 8_192):
        for k in (33, 256, 320, 512):
            # the tensor-core sweep of eval_fused / eval_topk at this k
            assert mips_mod.sweep_smem(n_q, 173_520, 256, k, 132) <= MAX_SMEM
            # the chain's finishing sweep, f32 FMAs at 16 rows a block
            sweep = max(mips_mod.partial_smem_bytes(1, 256, k),
                        mips_mod.merge_smem_bytes(k))
            chain = mips_mod.select_smem(n_q, 173_520, 256, k, 132)
            sp = mips_mod.select_plan(n_q, 173_520, 256, k, 132)
            assert chain == mips_mod.planned_smem(n_q, 173_520, 256, k, 132)
            assert max(sweep, mips_mod.pass_smem_bytes(256),
                       mips_mod.sort_smem_bytes(sp.kcap),
                       mips_mod.sort_smem_bytes(mips_mod.UNION_PER_SPLIT
                                                * sp.n_split)) <= chain
            assert chain <= MAX_SMEM
    # the dispatch checks mips_topk's own plan, the eval sweeps theirs
    q, y = torch.zeros(320, 256), torch.zeros(173_520, 256)
    for k in (10, 320):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops, "_n_sm", lambda device: 132)
            assert ops._sweep_smem(q, y, k)() == \
                mips_mod.sweep_smem(320, 173_520, 256, k, 132)
            assert ops._sweep_smem(q, y, k, mips_mod.planned_smem)() == \
                mips_mod.planned_smem(320, 173_520, 256, k, 132)


# ---------------------------------------------------------------------------
# Policy drills
# ---------------------------------------------------------------------------
def test_policy_knob(monkeypatch):
    assert guard.policy() == "warn"
    monkeypatch.setenv("REPRO_GUARD", "strict")
    assert guard.policy() == "strict"
    guard.set_policy("off")
    assert guard.policy() == "off"
    monkeypatch.setenv("REPRO_GUARD", "paranoid")
    guard.set_policy(None)
    with pytest.raises(ValueError):
        guard.policy()
    with pytest.raises(ValueError):
        guard.set_policy("paranoid")


def _broken_kernel(*args, **kwargs):
    raise RuntimeError("injected miscompile")


@pytest.fixture
def cuda_route(monkeypatch):
    """Every ``ops`` entry takes the CUDA route on CPU tensors, and
    ``mips_topk``'s wrapper is broken."""
    monkeypatch.setattr(ops, "_device_kind", lambda op, *t: "cuda")
    monkeypatch.setattr(mips_mod, "mips_topk", _broken_kernel)
    monkeypatch.setattr(ops, "_sweep_smem", lambda *a: (lambda: 0))


def _qy():
    rng = np.random.default_rng(2)
    return (torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(10, 8)).astype(np.float32)))


@pytest.mark.parametrize("pol", ["warn", "strict"])
def test_broken_kernel_raises_under_warn_and_strict(cuda_route, pol):
    guard.set_policy(pol)
    q, y = _qy()
    with pytest.raises(guard.KernelConformanceError) as ei:
        ops.mips_topk(q, y, 4)
    assert ei.value.kernel == "mips_topk"
    assert any("injected miscompile" in f for f in ei.value.failures)
    v = guard.verdict_for("mips_topk", device="cpu")
    assert not v.passed and v.n_fail == 3
    assert any(not r["passed"] for r in guard.verdict_table())


def test_policy_off_reaches_the_broken_kernel(cuda_route):
    guard.set_policy("off")
    q, y = _qy()
    with pytest.raises(RuntimeError, match="injected miscompile"):
        ops.mips_topk(q, y, 4)
    assert guard.verdict_table() == []  # no verdict consulted


def test_cpu_dispatch_consults_no_verdict(monkeypatch):
    monkeypatch.setattr(mips_mod, "mips_topk", _broken_kernel)
    guard.set_policy("strict")
    q, y = _qy()
    vals, ids = ops.mips_topk(q, y, 4)
    want = ref.mips_topk_ref(q, y, 4)
    assert torch.equal(vals, want[0]) and torch.equal(ids, want[1])
    assert guard.verdict_table() == []


def test_fixed_kernel_passes_after_clear(cuda_route, monkeypatch):
    guard.set_policy("warn")
    q, y = _qy()
    with pytest.raises(guard.KernelConformanceError):
        ops.mips_topk(q, y, 4)
    # a "fixed" kernel: the plain version in the wrapper's place
    monkeypatch.setattr(mips_mod, "mips_topk",
                        lambda q, y, k, valid=None, id_offset=0, kcap=None:
                        ref.mips_topk_ref(q, y, k, valid=valid,
                                          id_offset=id_offset))
    assert not guard.verdict_for("mips_topk", device="cpu").passed
    guard.clear_verdicts("mips_topk")
    assert guard.kernel_enabled("mips_topk", device="cpu") is True
    got = ops.mips_topk(q, y, 4)
    assert torch.equal(got[1], ref.mips_topk_ref(q, y, 4)[1])


def test_canaries_keep_the_callers_grad_mode_and_rng():
    """A canary with autograd runs from inside ``no_grad`` and inference
    mode, and leaves the caller's torch RNG where it was."""
    torch.manual_seed(5)
    before = torch.get_rng_state()
    with torch.inference_mode():
        v = guard.verdict_for("sce_bucket", device="cpu")
    with torch.no_grad():
        w = guard.verdict_for("linear_sce", device="cpu")
    assert v.passed and w.passed
    assert torch.equal(torch.get_rng_state(), before)
