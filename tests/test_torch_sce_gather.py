"""The port's in-bucket SCE loss with gathered candidates against the JAX
package's.

The port's plain ``sce_gather_loss_ref`` (the CPU path of
``kernels.ops.sce_gather_loss`` and the yardstick of the CUDA kernels) is
held against ``repro.kernels.ops.sce_gather_loss`` run as the JAX
package's own tests run it on the CPU (Pallas interpret mode, small
blocks) and against ``repro.kernels.ref.sce_bucket_loss_ref``. Inputs
are numpy arrays from a seed, handed to both sides.

Tolerances are the JAX package's own for this kernel
(``tests/test_kernels.py``), scaled to the tensor: losses within
``1e-5·max|loss|``; gradients ``rtol 2e-4`` and ``atol 1e-5·max|grad|``
(f32 sums folded in another order).
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

GATHER_SHAPES = [  # (n_b, b_x, b_y, d, C), as tests/test_kernels.py
    (2, 16, 24, 8, 100),
    (3, 100, 50, 16, 257),  # non-divisible everything
    (1, 8, 40, 4, 40),
]


def _problem(seed, n_b, b_x, b_y, d, c):
    """x_b, y, idx_y, tgt_b, cand_ids, pos as numpy: real collisions in
    slot 0 and an invalid (cand = −1) last slot."""
    rng = np.random.default_rng(seed)
    x_b = rng.standard_normal((n_b, b_x, d)).astype(np.float32)
    y = rng.standard_normal((c, d)).astype(np.float32)
    idx = rng.integers(0, c, (n_b, b_y)).astype(np.int32)
    tgt = rng.integers(0, c, (n_b, b_x)).astype(np.int32)
    cand = idx.copy()
    cand[:, 0] = tgt[:, 0]
    cand[:, -1] = -1
    pos = rng.standard_normal((n_b, b_x)).astype(np.float32)
    return x_b, y, idx, tgt, cand, pos


def _jax_loss_and_grads(x_b, y, idx, tgt, cand, pos, g, cap=None,
                        block=16):
    def f(x_b, y, pos):
        loss = jops.sce_gather_loss(
            x_b, y, idx, tgt, cand, pos, block_bx=block, block_by=block,
            interpret=True, logit_softcap=cap,
        )
        return jnp.sum(loss * g), loss

    (_, loss), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(x_b), jnp.asarray(y), jnp.asarray(pos))
    return np.asarray(loss), [np.asarray(a) for a in grads]


def _torch_loss_and_grads(x_b, y, idx, tgt, cand, pos, g, cap=None):
    xt, yt, pt = (torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (x_b, y, pos))
    loss = ops.sce_gather_loss(
        xt, yt, torch.from_numpy(idx), torch.from_numpy(tgt),
        torch.from_numpy(cand), pt, logit_softcap=cap,
    )
    grads = torch.autograd.grad((loss * torch.from_numpy(g)).sum(),
                                (xt, yt, pt))
    return loss.detach().numpy(), [a.numpy() for a in grads]


def _close_values(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _close_grads(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=2e-4,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("shape", GATHER_SHAPES)
def test_loss_matches_jax_kernel_and_ref(shape):
    x_b, y, idx, tgt, cand, pos = _problem(0, *shape)
    got = ref.sce_gather_loss_ref(
        *(torch.from_numpy(a) for a in (x_b, y, idx, tgt, cand, pos))
    ).numpy()
    want_kernel = np.asarray(jops.sce_gather_loss(
        jnp.asarray(x_b), jnp.asarray(y), idx, tgt, cand, jnp.asarray(pos),
        block_bx=16, block_by=16, interpret=True,
    ))
    want_ref = np.asarray(jref.sce_bucket_loss_ref(
        jnp.asarray(x_b), jnp.take(jnp.asarray(y), idx, axis=0), tgt, cand,
        jnp.asarray(pos),
    ))
    assert got.shape == (shape[0], shape[1]) and np.isfinite(got).all()
    _close_values(got, want_kernel)
    _close_values(got, want_ref)


@pytest.mark.parametrize("shape,cap", [
    (GATHER_SHAPES[0], None), (GATHER_SHAPES[1], None),
    (GATHER_SHAPES[1], 30.0),
])
def test_grads_match_jax_kernel(shape, cap):
    """dX, dY and d_pos: torch autograd through the plain version against
    jax.grad through the Pallas kernel's custom VJP, for a random upstream
    cotangent; rows of dY that no bucket selected are exactly zero."""
    x_b, y, idx, tgt, cand, pos = _problem(1, *shape)
    if cap is not None:  # logits large enough for the cap to bite
        x_b *= 8.0
        pos = cap * np.tanh(pos * 20.0 / cap)  # arrives capped
    g = np.random.default_rng(2).random(pos.shape).astype(np.float32)
    loss_t, grads_t = _torch_loss_and_grads(x_b, y, idx, tgt, cand, pos, g,
                                            cap)
    loss_j, grads_j = _jax_loss_and_grads(x_b, y, idx, tgt, cand, pos, g, cap)
    _close_values(loss_t, loss_j)
    _close_grads(grads_t, grads_j)
    touched = np.zeros(y.shape[0], bool)
    touched[idx.ravel()] = True
    assert (grads_t[1][~touched] == 0).all()
    assert (grads_j[1][~touched] == 0).all()


def test_duplicate_rows_across_buckets():
    """Every bucket selects the same candidate rows (maximal revisiting of
    a dY row): each row's gradient is the sum over the buckets."""
    n_b, b_x, d, c = 4, 8, 8, 30
    rng = np.random.default_rng(3)
    x_b = rng.standard_normal((n_b, b_x, d)).astype(np.float32)
    y = rng.standard_normal((c, d)).astype(np.float32)
    idx = np.tile(np.arange(12, dtype=np.int32)[None, :], (n_b, 1))
    tgt = rng.integers(12, c, (n_b, b_x)).astype(np.int32)  # no collisions
    pos = rng.standard_normal((n_b, b_x)).astype(np.float32)
    g = np.ones_like(pos)
    _, grads_t = _torch_loss_and_grads(x_b, y, idx, tgt, idx, pos, g)
    _, grads_j = _jax_loss_and_grads(x_b, y, idx, tgt, idx, pos, g, block=4)
    _close_grads(grads_t, grads_j)
    assert (grads_t[1][12:] == 0).all()


def test_negative_cand_ids_are_masked():
    """A candidate id < 0 is masked for every position: the loss changes
    when that slot is made valid, and the slot's row gets no gradient."""
    x_b, y, idx, tgt, cand, pos = _problem(4, 2, 8, 12, 4, 50)
    t = {k: torch.from_numpy(v) for k, v in dict(
        x_b=x_b, y=y, idx=idx, tgt=tgt, pos=pos).items()}
    masked = ref.sce_gather_loss_ref(t["x_b"], t["y"], t["idx"], t["tgt"],
                                     torch.from_numpy(cand), t["pos"])
    valid = cand.copy()
    valid[:, -1] = idx[:, -1]
    unmasked = ref.sce_gather_loss_ref(t["x_b"], t["y"], t["idx"], t["tgt"],
                                       torch.from_numpy(valid), t["pos"])
    assert not torch.allclose(masked, unmasked)
    want = np.asarray(jref.sce_bucket_loss_ref(
        jnp.asarray(x_b), jnp.take(jnp.asarray(y), idx, axis=0), tgt, cand,
        jnp.asarray(pos)))
    _close_values(masked.numpy(), want)


def test_cpu_dispatch_takes_plain_version_and_kernels_refuse_cpu():
    x_b, y, idx, tgt, cand, pos = (torch.from_numpy(a) for a in
                                   _problem(5, *GATHER_SHAPES[0]))
    counts = (kernel.sce_gather_fwd.launches, kernel.sce_gather_dx.launches,
              kernel.sce_gather_dy.launches)
    got = ops.sce_gather_loss(x_b, y, idx, tgt, cand, pos)
    want = ref.sce_gather_loss_ref(x_b, y, idx, tgt, cand, pos)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.sce_gather_fwd(x_b, y, idx, tgt, cand, pos)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.sce_gather_loss(*(t.to("meta") for t in
                              (x_b, y, idx, tgt, cand, pos)))
    assert (kernel.sce_gather_fwd.launches, kernel.sce_gather_dx.launches,
            kernel.sce_gather_dy.launches) == counts == (0, 0, 0)
