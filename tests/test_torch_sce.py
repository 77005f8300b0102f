"""The port's SCE loss (``repro_torch.core.sce``) against the JAX
package's (``repro.core.sce``).

Every random draw is made once and handed to both sides: the bucket
centres' Ω comes from ``jax.random.normal`` exactly as the reference's
``make_bucket_centers`` draws it, and is injected into the port. Inputs
are numpy arrays from a seed. The JAX kernel path runs as the JAX
package's own tests run it on the CPU (Pallas interpret mode).

Tolerances: selected ids equal exactly; values within ``1e-5`` of the
tensor's own magnitude; gradients ``rtol 2e-4``, ``atol 1e-5·max|grad|``
(f32 sums folded in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sce as jsce
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro_torch.core import sce
from repro_torch.kernels import ref
from repro_torch.kernels.topk_merge import ID_PAD
from repro_torch.launch import steps


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _omega(seed, n_b, n):
    """The reference's Mix draw: ``jax.random.normal(key, (n_b, N))``."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n_b, n),
                                        jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _close_grads(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,c,kw", [
    (25_600, 173_511, {}),  # the paper's training shape: 128 × 200
    (64, 500, {}),
    (1_000, 50, {"bucket_size_y": 512}),
    (300, 10_000, {"alpha": 1.5, "beta": 2.0, "bucket_size_y": 128}),
    (1, 3, {}),
])
def test_from_alpha_beta_matches_reference(n, c, kw):
    got = sce.SCEConfig.from_alpha_beta(n, c, **kw)
    want = jsce.SCEConfig.from_alpha_beta(n, c, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if n == 25_600:
        assert (got.n_buckets, got.bucket_size_x, got.bucket_size_y) == \
            (320, 320, 256)
    for tp in (1, 3):
        got_b = steps.build_sce_config(n, c, bucket_size_y=256, tp=tp)
        want_b = jsteps.build_sce_config(n, c, bucket_size_y=256, tp=tp)
        assert dataclasses.asdict(got_b) == dataclasses.asdict(want_b)


def test_memory_models_match_reference():
    cfg = sce.SCEConfig.from_alpha_beta(25_600, 173_511)
    jcfg = jsce.SCEConfig.from_alpha_beta(25_600, 173_511)
    for fused in (False, True):
        assert sce.sce_peak_elements(cfg, 25_600, 173_520, 64, fused=fused) \
            == jsce.sce_peak_elements(jcfg, 25_600, 173_520, 64, fused=fused)
        assert sce.sce_loss_memory_bytes(
            cfg, n_positions=25_600, catalog=173_520, d_model=64,
            fused=fused,
        ) == jsce.sce_loss_memory_bytes(
            jcfg, n_positions=25_600, catalog=173_520, d_model=64,
            fused=fused,
        )
    assert sce.sce_loss_memory_bytes(cfg) == jsce.sce_loss_memory_bytes(jcfg)
    assert sce.full_ce_memory_bytes(25_600, 173_520) == \
        jsce.full_ce_memory_bytes(25_600, 173_520)


# ---------------------------------------------------------------------------
# Bucket centres and selection
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_mix", [True, False])
def test_bucket_centers_with_injected_draw(use_mix):
    rng = np.random.default_rng(0)
    n, d, n_b = 96, 16, 7
    x = rng.standard_normal((n, d)).astype(np.float32)
    valid = rng.random(n) > 0.3
    key = jax.random.PRNGKey(11)
    want = np.asarray(jsce.make_bucket_centers(
        key, jnp.asarray(x), n_b, use_mix=use_mix,
        valid_mask=jnp.asarray(valid)))
    draw = np.asarray(jax.random.normal(
        key, (n_b, n) if use_mix else (n_b, d), jnp.float32))
    got = sce.make_bucket_centers(
        _t(x), n_b, use_mix=use_mix, valid_mask=_t(valid), omega=_t(draw)
    ).numpy()
    assert got.shape == (n_b, d)
    _close(got, want)


def _selection_inputs(integer, n=64, c=300, d=8, seed=1):
    rng = np.random.default_rng(seed)
    if integer:  # exact in any fold order, so ties are real ties
        draw = lambda *s: rng.integers(-2, 3, s).astype(np.float32)  # noqa
    else:
        draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    return draw(6, d), draw(n, d), draw(c, d)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("case", ["float", "int_ties", "starved"])
def test_select_buckets_ids_equal_reference(use_kernel, case):
    b, x, y = _selection_inputs(case != "float")
    valid = np.ones(x.shape[0], bool)
    valid[::3] = False
    if case == "starved":  # fewer valid positions than b_x: ID_PAD tail
        valid[:] = False
        valid[[5, 9, 40]] = True
    cfg = sce.SCEConfig(n_buckets=6, bucket_size_x=12, bucket_size_y=40,
                        use_kernel=use_kernel)
    jcfg = jsce.SCEConfig(n_buckets=6, bucket_size_x=12, bucket_size_y=40,
                          use_kernel=use_kernel)
    want_x, want_y = (np.asarray(a) for a in jsce.select_buckets(
        jnp.asarray(b), jnp.asarray(x), jnp.asarray(y), jcfg,
        valid_mask=jnp.asarray(valid)))
    got_x, got_y = sce.select_buckets(_t(b), _t(x), _t(y), cfg,
                                      valid_mask=_t(valid))
    assert got_x.dtype == got_y.dtype == torch.int32
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    np.testing.assert_array_equal(got_y.numpy(), want_y)
    if case == "starved":
        assert not (got_x == ID_PAD).any()
        assert not valid[got_x.numpy()[:, 3:]].any()


def test_sanitize_placeholder_ids():
    idx = torch.tensor([[4, ID_PAD], [ID_PAD, 1]], dtype=torch.int32)
    valid = torch.tensor([True, True, False, True, False])
    got = sce._sanitize_placeholder_ids(idx, valid)
    assert got.tolist() == [[4, 2], [2, 1]]
    assert sce._sanitize_placeholder_ids(idx, None) is idx


@pytest.mark.parametrize("k", [320, 512])
def test_mips_topk_ref_large_k_matches_reference(k):
    """The selection sizes of SCE training: b_x = 320 at the paper's
    shape, and the kernel's cap of 512."""
    rng = np.random.default_rng(k)
    q = rng.integers(-2, 3, (5, 16)).astype(np.float32)
    y = rng.integers(-2, 3, (1_100, 16)).astype(np.float32)
    valid = rng.random(1_100) > 0.25
    got = ref.mips_topk_ref(_t(q), _t(y), k, valid=_t(valid), chunk=256)
    want = jref.mips_topk_ref(jnp.asarray(q), jnp.asarray(y), k,
                              valid=jnp.asarray(valid), chunk=256)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# Aggregation and the whole loss
# ---------------------------------------------------------------------------
def test_aggregate_matches_reference_with_a_tie():
    """Position 2 sits in buckets 0 and 1 with the same loss: the max's
    gradient splits 0.5/0.5, as ``segment_max``'s does."""
    losses = np.array([[1.0, 2.0, 3.0], [3.0, 0.5, 4.0]], np.float32)
    idx_x = np.array([[0, 1, 2], [2, 3, 5]], np.int32)
    valid = np.array([True, True, True, True, False, False])

    def jf(l):
        return jsce.aggregate_bucket_losses(l, jnp.asarray(idx_x), 6,
                                            valid_mask=jnp.asarray(valid))

    want, want_cov = jf(jnp.asarray(losses))
    want_g = np.asarray(jax.grad(lambda l: jf(l)[0])(jnp.asarray(losses)))
    lt = _t(losses).requires_grad_(True)
    got, cov = sce.aggregate_bucket_losses(lt, _t(idx_x), 6,
                                           valid_mask=_t(valid))
    (g,) = torch.autograd.grad(got, lt)
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_array_equal(cov.numpy(), np.asarray(want_cov))
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6)
    assert g[0, 2].item() == g[1, 0].item() == pytest.approx(0.5 / 4)


def _loss_problem(seed=3, n=64, c=200, d=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (0.5 * rng.standard_normal((c, d))).astype(np.float32)
    targets = rng.integers(1, c, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    return x, y, targets, valid


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sce_loss_value_aux_and_grads_match_reference(use_kernel):
    x, y, targets, valid = _loss_problem()
    kw = dict(n_buckets=8, bucket_size_x=16, bucket_size_y=48,
              use_kernel=use_kernel)
    cfg, jcfg = sce.SCEConfig(**kw), jsce.SCEConfig(**kw)
    key = jax.random.PRNGKey(7)

    def jf(x, y):
        return jsce.sce_loss(x, y, jnp.asarray(targets), key=key, cfg=jcfg,
                             valid_mask=jnp.asarray(valid), return_aux=True)

    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    got, aux = sce.sce_loss(xt, yt, _t(targets), cfg=cfg,
                            valid_mask=_t(valid),
                            omega=_t(_omega(7, 8, x.shape[0])),
                            return_aux=True)
    got_g = torch.autograd.grad(got, (xt, yt))
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    for name, v in want_aux.items():
        assert float(aux[name]) == pytest.approx(float(v), rel=1e-6), name
    for a, b in zip(got_g, want_g):
        _close_grads(a.numpy(), np.asarray(b))
