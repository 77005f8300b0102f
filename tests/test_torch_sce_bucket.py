"""The port's in-bucket SCE over pre-gathered candidates against the JAX
package's (``kernels/sce_bucket.py``).

The port's plain ``ops.sce_bucket_loss`` / ``ops.sce_bucket_plse`` (on
the CPU: ``ref.sce_bucket_loss_ref`` / ``sce_bucket_plse_ref``, the
yardsticks of the CUDA kernels) are held against
``repro.kernels.ref.sce_bucket_*_ref`` and, for the values, against
``repro.kernels.ops.sce_bucket_*`` run as the JAX package's own tests run
it on the CPU (Pallas interpret mode, small blocks); gradients in ``x_b``,
``y_b`` and ``pos`` against ``jax.grad``. Cases: collisions with the
target, ``cand < 0`` slots, a bucket with every candidate masked, softcap
5 past its knee, a ragged shape (b_x = 23, b_y = 50, d = 33).

Tolerances: values within ``1e-5·max|value|``; gradients within
``1e-5·max|g|`` plus ``1e-4·|g|`` (f32 sums in another fold order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import guard as jguard
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

NEG_INF = -1e30
CASES = [  # (n_b, b_x, b_y, d, softcap)
    (2, 16, 24, 8, None),
    (2, 16, 24, 8, 5.0),
    (3, 23, 50, 33, None),  # ragged
]


@pytest.fixture(autouse=True)
def _jax_guard_off():
    jguard.set_policy("off")  # the Pallas kernel itself, in interpret mode
    yield
    jguard.set_policy(None)


def _problem(seed, n_b, b_x, b_y, d, cap):
    """x_b, y_b, tgt, cand, pos, g as numpy: a collision in slot 0, an
    invalid last slot, bucket 0's last row's every candidate masked."""
    rng = np.random.default_rng(seed)
    x_b = rng.standard_normal((n_b, b_x, d)).astype(np.float32)
    if cap is not None:
        x_b *= 4.0
    y_b = rng.standard_normal((n_b, b_y, d)).astype(np.float32)
    tgt = rng.integers(0, 500, (n_b, b_x)).astype(np.int32)
    cand = rng.integers(0, 500, (n_b, b_y)).astype(np.int32)
    cand[:, 0] = tgt[:, 0]
    cand[:, -1] = -1
    cand[1] = -1  # a bucket with no candidate left
    pos = rng.standard_normal((n_b, b_x)).astype(np.float32)
    if cap is not None:
        pos = (cap * np.tanh(pos * 3.0 / cap)).astype(np.float32)
    g = rng.random((n_b, b_x)).astype(np.float32)
    return x_b, y_b, tgt, cand, pos, g


def _close(got, want, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    tol = 1e-5 * np.abs(want).max() + rtol * np.abs(want)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_sce_bucket_loss_matches_reference(case):
    *shape, cap = case
    x_b, y_b, tgt, cand, pos, g = _problem(sum(shape), *shape, cap)
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (x_b, y_b, pos)]
    loss = ops.sce_bucket_loss(leaves[0], leaves[1], torch.from_numpy(tgt),
                               torch.from_numpy(cand), leaves[2],
                               logit_softcap=cap)
    got = torch.autograd.grad((loss * torch.from_numpy(g)).sum(), leaves)

    def f(x_b, y_b, pos):
        loss = jref.sce_bucket_loss_ref(x_b, y_b, tgt, cand, pos, cap)
        return jnp.sum(loss * g), loss

    (_, want_loss), want = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray,
                                                 (x_b, y_b, pos)))
    _close(loss.detach().numpy(), want_loss)
    for a, b in zip(got, want):
        _close(a.numpy(), b, rtol=1e-4)
    assert (got[1].numpy()[cand < 0] == 0).all()  # masked slots: exact 0
    kernel = jops.sce_bucket_loss(*map(jnp.asarray, (x_b, y_b, tgt, cand,
                                                     pos)),
                                  block_bx=8, block_by=16, interpret=True,
                                  logit_softcap=cap)
    _close(loss.detach().numpy(), kernel)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_sce_bucket_plse_matches_reference(case):
    *shape, cap = case
    x_b, y_b, tgt, cand, _, g = _problem(sum(shape) + 1, *shape, cap)
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (x_b, y_b)]
    plse = ops.sce_bucket_plse(leaves[0], leaves[1], torch.from_numpy(tgt),
                               torch.from_numpy(cand), logit_softcap=cap)
    got = torch.autograd.grad((plse * torch.from_numpy(g)).sum(), leaves)

    def f(x_b, y_b):
        plse = jref.sce_bucket_plse_ref(x_b, y_b, tgt, cand, cap)
        return jnp.sum(plse * g), plse

    (_, want_plse), want = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x_b), jnp.asarray(y_b))
    plse = plse.detach().numpy()
    want_plse = np.asarray(want_plse)
    dead = want_plse <= NEG_INF / 2
    assert dead[1].all() and not dead[0].any()
    np.testing.assert_array_equal(plse[dead], want_plse[dead])
    _close(plse[~dead], want_plse[~dead])
    for a, b in zip(got, want):
        _close(a.numpy(), b, rtol=1e-4)
    assert (got[0].numpy()[1] == 0).all()  # no candidate: exactly 0 in dX
    kernel = np.asarray(jops.sce_bucket_plse(
        *map(jnp.asarray, (x_b, y_b, tgt, cand)), block_bx=8, block_by=16,
        interpret=True, logit_softcap=cap))
    np.testing.assert_array_equal(plse[dead], kernel[dead])
    _close(plse[~dead], kernel[~dead])


def test_sce_bucket_is_sce_gather_on_gathered_rows():
    """On the CPU the pre-gathered loss is the gathered one on
    ``y_b = y[idx]``, value and gradient (the scatter-add of dY_b)."""
    rng = np.random.default_rng(9)
    x_b = torch.from_numpy(rng.standard_normal((3, 10, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (3, 12)).astype(np.int32))
    tgt = torch.from_numpy(rng.integers(0, 40, (3, 10)).astype(np.int32))
    pos = torch.from_numpy(rng.standard_normal((3, 10)).astype(np.float32))
    yy = y.clone().requires_grad_(True)
    a = ops.sce_bucket_loss(x_b, yy[idx.long()], tgt, idx, pos)
    (ga,) = torch.autograd.grad(a.sum(), yy)
    yy = y.clone().requires_grad_(True)
    b = ops.sce_gather_loss(x_b, yy, idx, tgt, idx, pos)
    (gb,) = torch.autograd.grad(b.sum(), yy)
    assert torch.equal(a, b) and torch.equal(ga, gb)


def test_sce_bucket_ops_reject_mixed_devices():
    x_b = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        ops.sce_bucket_plse(x_b, torch.zeros(1, 3, 4, device="meta"),
                            torch.zeros(1, 2, dtype=torch.int32),
                            torch.zeros(1, 3, dtype=torch.int32))
