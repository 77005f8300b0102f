"""The port's partial in-bucket logsumexp against the JAX package's.

The port's plain ``ops.sce_gather_plse`` (on the CPU:
``ref.sce_gather_plse_ref``, the yardstick of the CUDA kernel) is held
against ``repro.kernels.ref.sce_bucket_plse_ref`` on the gathered rows
and against ``repro.kernels.ops.sce_gather_plse`` run as the JAX
package's own tests run it on the CPU (Pallas interpret mode, small
blocks): values, and gradients against ``jax.grad``. Cases: ``cand < 0``,
collisions with the target, rows whose candidates are all masked (the
common case of the distributed exact mode, where every candidate another
shard owns arrives as ``cand = −1``), softcap 30, and a ragged shape
(b_x = 23, b_y = 50, d = 33).

Tolerances: values within ``1e-5·max|value|``; gradients ``rtol 1e-4``,
``atol 1e-6·max|g|``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sce_prefetch as kernel

NEG_INF = -1e30
SHAPES = [  # (n_b, b_x, b_y, d, C)
    (2, 16, 24, 8, 100),
    (3, 23, 50, 33, 257),  # ragged
]


def _problem(seed, n_b, b_x, b_y, d, c, *, cap=None, dead_rows=True):
    """x_b, y, idx_y, tgt_b, cand as numpy: a collision in slot 0, an
    invalid (cand = −1) last slot, and (``dead_rows``) bucket 0 with every
    candidate masked."""
    rng = np.random.default_rng(seed)
    x_b = rng.standard_normal((n_b, b_x, d)).astype(np.float32)
    if cap is not None:  # logits large enough for the cap to bite
        x_b *= 8.0
    y = rng.standard_normal((c, d)).astype(np.float32)
    idx = rng.integers(0, c, (n_b, b_y)).astype(np.int32)
    tgt = rng.integers(0, c, (n_b, b_x)).astype(np.int32)
    cand = idx.copy()
    cand[:, 0] = tgt[:, 0]
    cand[:, -1] = -1
    if dead_rows:
        cand[0] = -1
    return x_b, y, idx, tgt, cand


def _torch(x_b, y, idx, tgt, cand, g, cap):
    xt, yt = (torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (x_b, y))
    plse = ops.sce_gather_plse(xt, yt, torch.from_numpy(idx),
                               torch.from_numpy(tgt), torch.from_numpy(cand),
                               logit_softcap=cap)
    dx, dy = torch.autograd.grad((plse * torch.from_numpy(g)).sum(), (xt, yt))
    return plse.detach().numpy(), dx.numpy(), dy.numpy()


def _jax_ref(x_b, y, idx, tgt, cand, g, cap):
    def f(x_b, y):
        plse = jref.sce_bucket_plse_ref(x_b, jnp.take(y, idx, axis=0), tgt,
                                        cand, cap)
        return jnp.sum(plse * g), plse

    (_, plse), (dx, dy) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x_b), jnp.asarray(y))
    return np.asarray(plse), np.asarray(dx), np.asarray(dy)


def _close_values(got, want):
    live = want > NEG_INF / 2
    np.testing.assert_array_equal(got[~live], want[~live])
    np.testing.assert_allclose(got[live], want[live], rtol=0,
                               atol=1e-5 * np.abs(want[live]).max())


def _close_grad(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("shape", SHAPES, ids=["small", "ragged"])
def test_plse_and_grads_match_jax_ref(shape, cap):
    x_b, y, idx, tgt, cand = _problem(0, *shape, cap=cap)
    g = np.random.default_rng(1).random((shape[0], shape[1])).astype(
        np.float32)
    got = _torch(x_b, y, idx, tgt, cand, g, cap)
    want = _jax_ref(x_b, y, idx, tgt, cand, g, cap)
    assert np.isfinite(got[0]).all()
    _close_values(got[0], want[0])
    _close_grad(got[1], want[1])
    _close_grad(got[2], want[2])


@pytest.mark.parametrize("cap", [None, 30.0])
def test_plse_and_grads_match_jax_kernel(cap):
    """Against the Pallas kernel in interpret mode and its custom VJP."""
    shape = SHAPES[1]
    x_b, y, idx, tgt, cand = _problem(2, *shape, cap=cap)
    g = np.random.default_rng(3).random((shape[0], shape[1])).astype(
        np.float32)

    def f(x_b, y):
        plse = jops.sce_gather_plse(x_b, y, idx, tgt, cand, block_bx=16,
                                    block_by=16, interpret=True,
                                    logit_softcap=cap)
        return jnp.sum(plse * g), plse

    (_, want), (wdx, wdy) = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(x_b), jnp.asarray(y))
    plse, dx, dy = _torch(x_b, y, idx, tgt, cand, g, cap)
    _close_values(plse, np.asarray(want))
    _close_grad(dx, np.asarray(wdx))
    _close_grad(dy, np.asarray(wdy))


def test_all_masked_rows_are_neg_inf_with_zero_gradient():
    """A row whose candidates are all masked is exactly ``NEG_INF``
    (−1e30: ``NEG_INF + log(b_y)`` rounds to it in f32), never ``−inf``
    or NaN, and its dX row is exactly 0; dY rows that only masked slots
    gather get 0."""
    x_b, y, idx, tgt, cand = _problem(4, *SHAPES[0])
    g = np.ones((SHAPES[0][0], SHAPES[0][1]), np.float32)
    plse, dx, dy = _torch(x_b, y, idx, tgt, cand, g, None)
    assert (plse[0] == np.float32(NEG_INF)).all()
    assert np.isfinite(plse).all() and np.isfinite(dx).all()
    assert (dx[0] == 0).all() and (np.abs(dx[1:]).sum(-1) > 0).all()
    live_rows = np.unique(idx[1:, :-1])  # the last slot is cand = −1
    dead = np.setdiff1d(np.arange(y.shape[0]), live_rows)
    assert (dy[dead] == 0).all()


def test_ownership_split_merges_to_the_whole_partial():
    """Two shards owning complementary candidates (the exact mode's
    ``cand = −1`` for the other's rows): the log-space merge of their
    partials, the max taken on a detached copy, equals the partial over
    all candidates, value and gradients; a shard that owns none of a
    row's candidates adds exactly 0 to that row's dX, with no NaN."""
    x_b, y, idx, tgt, cand = _problem(5, *SHAPES[0], dead_rows=False)
    own = np.random.default_rng(6).random(idx.shape) > 0.5
    own[0] = True  # bucket 0: shard 1 owns nothing
    args = [torch.from_numpy(a) for a in (idx, tgt)]
    xt, yt = (torch.from_numpy(a).requires_grad_(True) for a in (x_b, y))
    whole = ops.sce_gather_plse(xt, yt, *args, torch.from_numpy(cand))
    w_dx, w_dy = torch.autograd.grad(whole.sum(), (xt, yt))

    parts = []
    for mine in (own, ~own):
        xs = torch.from_numpy(x_b).requires_grad_(True)
        c = torch.from_numpy(np.where(mine, cand, -1).astype(np.int32))
        parts.append((xs, ops.sce_gather_plse(xs, yt, *args, c)))
    g_m = torch.maximum(parts[0][1], parts[1][1]).detach()
    merged = g_m + torch.log(sum(torch.exp(p - g_m) for _, p in parts))
    grads = torch.autograd.grad(merged.sum(), [xs for xs, _ in parts] + [yt])
    np.testing.assert_allclose(merged.detach().numpy(),
                               whole.detach().numpy(), rtol=1e-6)
    _close_grad((grads[0] + grads[1]).numpy(), w_dx.numpy())
    _close_grad(grads[2].numpy(), w_dy.numpy())
    assert (parts[1][1][0] == NEG_INF).all()
    assert (grads[1][0] == 0).all() and torch.isfinite(grads[1]).all()


def test_cpu_dispatch_takes_plain_version_and_kernels_refuse_cpu():
    x_b, y, idx, tgt, cand = (torch.from_numpy(a) for a in
                              _problem(7, *SHAPES[0]))
    counts = (kernel.sce_gather_plse_fwd.launches,
              kernel.sce_gather_plse_dx.launches,
              kernel.sce_gather_plse_dy.launches)
    got = ops.sce_gather_plse(x_b, y, idx, tgt, cand)
    want = ref.sce_bucket_plse_ref(x_b, y[idx.long()], tgt, cand)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.sce_gather_plse_fwd(x_b, y, idx, tgt, cand)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.sce_gather_plse(*(t.to("meta") for t in
                              (x_b, y, idx, tgt, cand)))
    assert (kernel.sce_gather_plse_fwd.launches,
            kernel.sce_gather_plse_dx.launches,
            kernel.sce_gather_plse_dy.launches) == counts == (0, 0, 0)
