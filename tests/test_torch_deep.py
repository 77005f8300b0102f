"""The deep variants' plain versions and plans, on the CPU.

Above d = 256 (and, in ``mips_topk``'s chain, above k = 512) the CUDA
kernels run their deep variants (``csrc/deep_tc.cuh``'s depth-chunked
product, then the same selection or fold). Their yardstick is the plain
PyTorch versions of ``kernels/ref.py``, which take any d and k: here
those are held, at d 300 and gemma-2's 2304 with small n, against the
JAX kernels run as the JAX package's own tests run them (Pallas
interpret mode, small blocks), and ``mips_topk_ref`` at k 1024 against a
dense ``lax.top_k`` (the JAX kernel's merge unrolls k rounds). Integer
inputs make every fold order exact (ids, values and counts equal);
floats agree within ``1e-5`` of the tensor's magnitude, SCE gradients
within ``rtol 2e-4`` and ``atol 1e-5·max|grad|``.

The plans choose the deep variant exactly where the resident kernels
cannot take the shape, and every launch of theirs fits the 227 KB a
block may use, for every d up to 8192.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import guard as jguard
from repro.kernels import mips_topk as jax_mips
from repro.kernels import ops as jops
from repro_torch.kernels import deep, guard, linear_sce
from repro_torch.kernels import mips_topk as kernel
from repro_torch.kernels import ref, sce_prefetch

DEEP = [300, 2304]


def _ints(rng, *shape):
    return rng.integers(-2, 3, shape).astype(np.float32)


def _match(got, want, scale, exact):
    gv, gi = (np.asarray(a) for a in got)
    wv, wi = (np.asarray(a) for a in want)
    assert gv.shape == wv.shape
    if exact:
        assert np.array_equal(gv, wv) and np.array_equal(gi, wi)
        return
    tol = 1e-5 * scale
    assert np.abs(gv - wv).max() <= tol
    prv = np.concatenate([np.full_like(wv[:, :1], np.inf), wv[:, :-1]], 1)
    nxt = np.concatenate([wv[:, 1:], np.full_like(wv[:, :1], -np.inf)], 1)
    iso = ((prv - wv) > tol) & ((wv - nxt) > tol)
    assert np.array_equal(gi[iso], wi[iso])


@pytest.mark.parametrize("d", DEEP)
@pytest.mark.parametrize("integer,k", [(True, 10), (False, 10), (True, 40)])
def test_plain_mips_topk_matches_jax_kernel_deep(d, integer, k):
    rng = np.random.default_rng(d + k)
    q = _ints(rng, 6, d) if integer else rng.standard_normal(
        (6, d)).astype(np.float32)
    y = _ints(rng, 203, d) if integer else rng.standard_normal(
        (203, d)).astype(np.float32)
    want = jax_mips.mips_topk(jnp.asarray(q), jnp.asarray(y), k, block_q=8,
                              block_c=64, interpret=True)
    got = ref.mips_topk_ref(torch.from_numpy(q), torch.from_numpy(y), k,
                            chunk=64)
    _match((got[0].numpy(), got[1].numpy()), want,
           np.abs(q @ y.T).max(), integer)


@pytest.mark.parametrize("d,integer", [(16, True), (16, False),
                                       (300, False)])
def test_plain_mips_topk_at_k_1024_matches_dense_top_k(d, integer):
    """k = 1024 of 3,000 columns (the chain's deep lists), against
    ``lax.top_k`` of the dense scores, whose ties go to the lower id."""
    rng = np.random.default_rng(d)
    q = _ints(rng, 5, d) if integer else rng.standard_normal(
        (5, d)).astype(np.float32)
    y = _ints(rng, 3000, d) if integer else rng.standard_normal(
        (3000, d)).astype(np.float32)
    want = jax.lax.top_k(jnp.asarray(q) @ jnp.asarray(y).T, 1024)
    got = ref.mips_topk_ref(torch.from_numpy(q), torch.from_numpy(y), 1024)
    assert got[1].dtype == torch.int32
    _match((got[0].numpy(), got[1].numpy()),
           (np.asarray(want[0]), np.asarray(want[1]).astype(np.int32)),
           np.abs(q @ y.T).max(), integer)


def _sce_problem(seed, n_b, b_x, b_y, d, c):
    rng = np.random.default_rng(seed)
    x_b = rng.standard_normal((n_b, b_x, d)).astype(np.float32) / 8
    y = rng.standard_normal((c, d)).astype(np.float32) / 8
    idx = rng.integers(0, c, (n_b, b_y)).astype(np.int32)
    tgt = rng.integers(0, c, (n_b, b_x)).astype(np.int32)
    cand = idx.copy()
    cand[:, 0] = tgt[:, 0]
    cand[:, -1] = -1
    pos = rng.standard_normal((n_b, b_x)).astype(np.float32)
    g = rng.random((n_b, b_x)).astype(np.float32)
    return x_b, y, idx, tgt, cand, pos, g


def _close(got, want, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    tol = 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= tol + rtol * np.abs(want)).all(), \
        np.abs(got - want).max()


@pytest.mark.parametrize("d", DEEP)
@pytest.mark.parametrize("cap", [None, 30.0])
def test_plain_sce_gather_matches_jax_kernel_deep(d, cap):
    """The loss and its gradients (x_b, y, pos), and the partial LSE and
    its gradients, against the JAX kernels' VJP in interpret mode."""
    x_b, y, idx, tgt, cand, pos, g = _sce_problem(d, 2, 16, 24, d, 100)

    def jloss(x_b, y, pos):
        loss = jops.sce_gather_loss(x_b, y, idx, tgt, cand, pos,
                                    block_bx=16, block_by=16, interpret=True,
                                    logit_softcap=cap)
        return jnp.sum(loss * g), loss

    def jplse(x_b, y):
        plse = jops.sce_gather_plse(x_b, y, idx, tgt, cand, block_bx=16,
                                    block_by=16, interpret=True,
                                    logit_softcap=cap)
        return jnp.sum(plse * g), plse

    (_, want), wgrads = jax.value_and_grad(jloss, (0, 1, 2), has_aux=True)(
        jnp.asarray(x_b), jnp.asarray(y), jnp.asarray(pos))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x_b, y, pos)]
    loss = ref.sce_gather_loss_ref(leaves[0], leaves[1],
                                   torch.from_numpy(idx),
                                   torch.from_numpy(tgt),
                                   torch.from_numpy(cand), leaves[2], cap)
    grads = torch.autograd.grad((loss * torch.from_numpy(g)).sum(), leaves)
    _close(loss.detach(), want)
    for a, b in zip(grads, wgrads):
        _close(a, b, 2e-4)

    (_, want), wgrads = jax.value_and_grad(jplse, (0, 1), has_aux=True)(
        jnp.asarray(x_b), jnp.asarray(y))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x_b, y)]
    plse = ref.sce_gather_plse_ref(leaves[0], leaves[1],
                                   torch.from_numpy(idx),
                                   torch.from_numpy(tgt),
                                   torch.from_numpy(cand), cap)
    grads = torch.autograd.grad((plse * torch.from_numpy(g)).sum(), leaves)
    _close(plse.detach(), want)
    for a, b in zip(grads, wgrads):
        _close(a, b, 2e-4)


@pytest.mark.parametrize("d", DEEP)
@pytest.mark.parametrize("k,with_lse", [(1, True), (10, False)])
def test_plain_eval_fused_matches_jax_kernel_deep(d, k, with_lse):
    """On integers: ids, values, gt, eq and the target score equal the
    JAX kernel's (interpret mode); the LSE (cap 30, the token-rank
    protocol's) within 1e-5 relative. The JAX guard is off: on this CPU
    its eval_fused canaries fail and would degrade to its plain path."""
    rng = np.random.default_rng(d + k)
    x, y = _ints(rng, 6, d), _ints(rng, 200, d)
    t = rng.integers(1, 190, 6).astype(np.int32)
    kw = dict(c_lo=1, c_hi=190, with_lse=with_lse,
              logit_softcap=30.0 if with_lse else None)
    jguard.set_policy("off")  # its CPU canaries fail (ROADMAP queue 3)
    try:
        want = jops.eval_fused(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(t), k, block_b=8, block_c=64,
                               interpret=True, **kw)
    finally:
        jguard.set_policy(None)
    got = ref.eval_fused_ref(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(t), k, chunk=64, **kw)
    for a, b in zip(got[:5], want[:5]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if with_lse:
        lse = (got[5] + torch.log(got[6])).numpy()
        wlse = np.asarray(want[5]) + np.log(np.asarray(want[6]))
        np.testing.assert_allclose(lse, wlse, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------
KS = (1, 10, 32, 33, 128, 320, 512, 513, 1024)


def test_mips_topk_plans_go_deep_exactly_where_the_resident_kernels_cannot():
    for d in (1, 64, 255, 256, 257, 300, 2304, 8192):
        for k in KS:
            assert kernel.is_deep(d, k) == (d > kernel.MAX_D
                                            or k > kernel.SHALLOW_MAX_K)
    # the resident launches fit where they run (k ≤ 512, d ≤ 256) ...
    for d in (1, 64, 256):
        for k in KS[:-2]:
            assert kernel.planned_smem(320, 173_520, d, k, 132) <= \
                kernel.MAX_SMEM
    # ... and the resident staging cannot hold d 257 (the 16-row split
    # sweep at k 320 and the chain's passes at k 512 overflow first)
    assert kernel.partial_smem_bytes(1, 512, 320) > kernel.MAX_SMEM
    assert kernel.sweep_smem_bytes(16, 257, 10) < \
        kernel.sweep_smem_bytes(16, 256, 10)  # the deep block is smaller


@pytest.mark.parametrize("n_q,c", [(128, 256_000), (8_192, 256_000),
                                   (8, 4_096)])
def test_deep_plans_fit_shared_memory_for_every_depth(n_q, c):
    """Every launch of every plan fits 227 KB at every d ≤ 8192: the
    k > 32 chain at k ≤ 1024, the sweep (mips_topk, eval_fused) at
    k ≤ 32 and up to 512."""
    for d in range(1, 8193):
        for k in (1, 32, 128, 1024):
            if k > c:
                continue
            assert kernel.planned_smem(n_q, c, d, k, 132) <= kernel.MAX_SMEM
        if d > kernel.MAX_D:
            assert kernel.sweep_smem(n_q, c, d, 512, 132) <= kernel.MAX_SMEM
        assert sce_prefetch.planned_smem(d) <= sce_prefetch.MAX_SMEM
        assert sce_prefetch.is_deep(d) == (d > sce_prefetch.MAX_D)


def test_slab_rows_bound_the_score_slab():
    # one sizer for every deep slab (deep.slab_rows): 1 GiB of f32
    assert kernel.slab_rows(8_192, 256_000) == 1_024
    assert kernel.slab_rows(128, 256_000) == 128
    assert kernel.slab_rows(5, 10) == 5
    assert kernel.slab_rows(10, 2**30) == 1
    for n_q, c in ((8_192, 256_000), (4_096, 173_520), (100, 3_000_000)):
        rows = kernel.slab_rows(n_q, c)
        assert 4 * c * rows <= deep.SLAB_BYTES or rows == 1
        assert rows < 128 or rows % 128 == 0


def test_the_sce_resident_plans_take_every_depth_to_256():
    for d in range(1, sce_prefetch.MAX_D + 1):
        assert not sce_prefetch.is_deep(d)
        assert sce_prefetch.fwd_plan(d)[1] <= sce_prefetch.MAX_SMEM
        assert sce_prefetch.bwd_plan(d)[1] <= sce_prefetch.MAX_SMEM


def test_preflight_d_max_follows_the_plans():
    """No group keeps a flat depth cap: every one, the full-CE kernels
    too, takes any d, its plans' shared memory the limit (the deep
    product's at d 2304, within the 227 KB); mips_topk takes k to 1024,
    the sweeps to 512."""
    base = dict(rows=8, cols=1000, d=2304, k=10)
    for group in ("mips_topk", "eval_fused", "eval_topk", "sce_gather",
                  "sce_bucket"):
        assert guard.preflight(group, **base).params["d"] == 2304
    for group in ("linear_sce", "fused_ce"):
        smem = linear_sce.planned_smem(2304)
        pf = guard.preflight(group, **dict(base, k=None), smem_bytes=smem)
        assert pf.params["d"] == 2304 and pf.smem_bytes == smem
        assert smem == linear_sce.DEEP_SMEM <= guard.MAX_SMEM
    assert "d_max" not in guard.PREFLIGHT_RULES
    guard.preflight("mips_topk", **dict(base, k=1024))
    for group, k in (("mips_topk", 1025), ("eval_fused", 513)):
        with pytest.raises(guard.KernelPreflightError) as ei:
            guard.preflight(group, **dict(base, k=k))
        assert ei.value.rule == "k_max"
    assert linear_sce.MAX_D == 256


@pytest.mark.parametrize("d,want", [
    (256, [("sce_gather_dx_launch", True, False),
           ("sce_gather_dy_launch", False, True)]),
    (300, [("sce_gather_bwd_deep_launch", True, True)]),
    (2304, [("sce_gather_bwd_deep_launch", True, True)]),
])
@pytest.mark.parametrize("plse", [False, True])
def test_sce_backward_writes_the_deep_cotangent_once(monkeypatch, d, want,
                                                     plse):
    """Autograd's backward of ``sce_gather_loss`` / ``sce_gather_plse``
    (``_grads``), with the launches recorded in place of the card: at
    d ≤ 256 the resident dX and dY kernels, a launch each; above, one
    deep launch that takes dX and dY's workspace together with the
    logits' workspace, so the cotangent is written once. Each wrapper's
    counter moves by one either way."""
    calls = []

    def record(name, args, shape, device):
        dx, dy = (args[7], args[8]) if "deep" in name else (
            (args[7], None) if "dx" in name else (None, args[7]))
        calls.append((name, dx is not None, dy is not None))
        if "deep" in name:
            n_b, b_x, b_y = shape[:3]
            assert args[9].numel() == n_b * b_x * b_y

    n_b, b_x, b_y, c = 2, 3, 4, 10
    x_b, y = torch.zeros(n_b, b_x, d), torch.zeros(c, d)
    ids = torch.zeros(n_b, b_y, dtype=torch.int32)
    rows = torch.zeros(n_b, b_x)
    args = (x_b, y, ids, torch.zeros(n_b, b_x, dtype=torch.int32), ids,
            rows, rows)
    monkeypatch.setattr(sce_prefetch, "_check",
                        lambda *a: (n_b, b_x, b_y, c, d))
    monkeypatch.setattr(sce_prefetch, "_launch", record)
    monkeypatch.setattr(sce_prefetch, "sce_gather_dy_sum",
                        lambda ws, keys, order, dy: dy)
    fns = ((sce_prefetch.sce_gather_plse_dx, sce_prefetch.sce_gather_plse_dy)
           if plse else (sce_prefetch.sce_gather_dx,
                         sce_prefetch.sce_gather_dy))
    for f in fns:  # the counters come back as they were
        monkeypatch.setattr(f, "launches", f.launches)
    before = [f.launches for f in fns]
    dx, dy = sce_prefetch._grads(*fns, args, 30.0, True, True)
    assert calls == want
    assert dx.shape == x_b.shape and dy.shape == y.shape
    assert [f.launches for f in fns] == [n + 1 for n in before]
    calls.clear()
    assert sce_prefetch._grads(*fns, args, 30.0, False, True)[0] is None
    assert calls == [(want[-1][0], False, True)]
