"""The port's streamed full-catalog CE against the JAX package's.

The port's plain ``linear_ce_loss``, ``fused_lse`` and ``fused_ce_loss``
(the CPU path of ``kernels.ops`` and the yardstick of the CUDA kernels)
and its plain backward ``linear_ce_dx_ref`` / ``linear_ce_dw_ref`` (the
yardstick of the dX and dW/dY kernels) are held against
``repro.kernels.linear_sce`` and ``repro.kernels.fused_ce`` run as the JAX
package's own tests run them on the CPU (Pallas interpret mode, small
blocks), and against ``jax.grad`` of ``repro.kernels.ref``. Inputs are
numpy arrays from a seed, handed to both sides; the cases cover cap none
and 30, a catalog that is not a multiple of the chunk, duplicate targets
and rows with a zero cotangent.

Tolerances: f32 sums folded in another order, scaled to the tensor's own
magnitude (a flat ``atol`` is not enough at large losses): values within
``1e-5·max|want|``, gradients within ``1e-5·max|grad|`` plus
``2e-4·|grad|``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_ce as jfused
from repro.kernels import linear_sce as jlinear
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

CHUNK = 64  # the catalog chunk of both sides' sweeps (C below is ragged)

CASES = {  # name: (N, C, d, cap, duplicate targets, zero-cotangent rows)
    "ragged_c": (40, 300, 16, None, False, False),
    "cap30": (40, 300, 16, 30.0, False, False),
    "duplicate_targets": (48, 200, 8, None, True, False),
    "zero_cotangent_rows_cap30": (33, 130, 12, 30.0, True, True),
}


def _problem(name):
    n, c, d, cap, dup, zero_rows = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    scale = 4.0 if cap is not None else 1.0  # logits past the cap's knee
    x = (scale * rng.standard_normal((n, d))).astype(np.float32)
    w = rng.standard_normal((c, d)).astype(np.float32)
    t = rng.integers(0, c, n).astype(np.int32)
    if dup:
        t[: n // 2] = rng.choice([3, c - 1], n // 2)  # the last, ragged tile
    g = rng.uniform(0.5, 1.5, n).astype(np.float32)
    if zero_rows:
        g[::3] = 0.0
    return x, w, t, g, cap


def _close(got, want, rtol=0.0):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    tol = 1e-5 * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= tol + rtol * np.abs(want)).all(), err.max()


def _torch_loss_and_grads(fn, x, w, g):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w)]
    out = fn(*leaves)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    return [out.detach().numpy()] + [t.numpy() for t in grads]


def _jax_loss_and_grads(fn, x, w, g):
    out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    return [np.array(out)] + [np.array(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_linear_ce_loss_matches_kernel_and_ref(name):
    x, w, t, g, cap = _problem(name)
    got = _torch_loss_and_grads(
        lambda a, b: ops.linear_ce_loss(a, b, torch.from_numpy(t),
                                        logit_softcap=cap, block_c=CHUNK),
        x, w, g)
    kernel = _jax_loss_and_grads(
        lambda a, b: jlinear.linear_ce_loss(a, b, jnp.asarray(t), cap, 16,
                                            CHUNK, True), x, w, g)
    plain = _jax_loss_and_grads(
        lambda a, b: jref.linear_ce_loss_ref(a, b, jnp.asarray(t),
                                             logit_softcap=cap, chunk=CHUNK),
        x, w, g)
    for want in (kernel, plain):
        _close(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            _close(a, b, rtol=2e-4)
    # The plain backward (the dX/dW kernels' yardstick) from the saved lse.
    lse = ref.fused_lse_ref(torch.from_numpy(x), torch.from_numpy(w),
                            logit_softcap=cap, chunk=CHUNK)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t),
            lse, torch.from_numpy(g))
    dx = ref.linear_ce_dx_ref(*args, logit_softcap=cap, chunk=CHUNK)
    dw = ref.linear_ce_dw_ref(*args, logit_softcap=cap, chunk=CHUNK)
    _close(dx.numpy(), kernel[1], rtol=2e-4)
    _close(dw.numpy(), kernel[2], rtol=2e-4)
    if name.startswith("zero_cotangent"):
        assert (dx.numpy()[g == 0] == 0).all()


@pytest.mark.parametrize("name", ["ragged_c", "duplicate_targets"])
def test_fused_ce_loss_matches_kernel_and_ref(name):
    x, w, t, g, _ = _problem(name)
    got = _torch_loss_and_grads(
        lambda a, b: ops.fused_ce_loss(a, b, torch.from_numpy(t),
                                       block_c=CHUNK), x, w, g)
    kernel = _jax_loss_and_grads(
        lambda a, b: jfused.fused_ce_loss(a, b, jnp.asarray(t), 16, CHUNK,
                                          True), x, w, g)
    plain = _jax_loss_and_grads(
        lambda a, b: jref.fused_ce_loss_ref(a, b, jnp.asarray(t)), x, w, g)
    for want in (kernel, plain):
        _close(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            _close(a, b, rtol=2e-4)


@pytest.mark.parametrize("name", ["ragged_c", "zero_cotangent_rows_cap30"])
def test_fused_lse_and_its_plain_backward_match_kernel(name):
    """``fused_lse`` and the one-hot-free plain backward
    (``linear_ce_dx_ref`` / ``linear_ce_dw_ref`` with ``targets=None``,
    the dX/dY kernels' yardstick) against the JAX kernel's custom VJP."""
    x, w, _, g, _ = _problem(name)
    got = _torch_loss_and_grads(
        lambda a, b: ops.fused_lse(a, b, block_c=CHUNK), x, w, g)
    kernel = _jax_loss_and_grads(
        lambda a, b: jfused.fused_lse(a, b, 16, CHUNK, True), x, w, g)
    _close(got[0], kernel[0])
    for a, b in zip(got[1:], kernel[1:]):
        _close(a, b, rtol=2e-4)
    args = (torch.from_numpy(x), torch.from_numpy(w), None,
            torch.from_numpy(kernel[0]), torch.from_numpy(g))
    dx = ref.linear_ce_dx_ref(*args, chunk=CHUNK)
    dw = ref.linear_ce_dw_ref(*args, chunk=CHUNK)
    _close(dx.numpy(), kernel[1], rtol=2e-4)
    _close(dw.numpy(), kernel[2], rtol=2e-4)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_linear_ce_loss_out_of_range_targets_pluck_zero(cap):
    """The contract of ``ops.linear_ce_loss`` on the CPU, as on the card: a
    target outside ``[0, C)`` — −1, C, and C + 3, which lies inside the
    plain version's last chunk's padding (C = 300 in chunks of 64) — plucks
    0, so its loss is exactly the row's lse, and the gradients are finite
    and those of the lse alone on such rows."""
    x, w, t, g, _ = _problem("ragged_c")
    c = w.shape[0]
    assert c % CHUNK and c + 3 < -(-c // CHUNK) * CHUNK
    out = np.zeros(len(t), dtype=bool)
    for i, bad in enumerate((-1, c, c + 3)):
        t[i::5] = bad
        out[i::5] = True
    xt, wt, tt, gt = map(torch.from_numpy, (x, w, t, g))
    leaves = [a.clone().requires_grad_(True) for a in (xt, wt)]
    loss = ops.linear_ce_loss(*leaves, tt, logit_softcap=cap, block_c=CHUNK)
    grads = torch.autograd.grad((loss * gt).sum(), leaves)
    lse = ref.fused_lse_ref(xt, wt, logit_softcap=cap, chunk=CHUNK)
    assert torch.equal(loss.detach()[out], lse[out])
    assert all(torch.isfinite(a).all() for a in grads)
    lse_leaves = [a.clone().requires_grad_(True) for a in (xt, wt)]
    lse_rows = ref.fused_lse_ref(*lse_leaves, logit_softcap=cap, chunk=CHUNK)
    want_dx = torch.autograd.grad((lse_rows * gt).sum(), lse_leaves)[0]
    _close(grads[0][out].numpy(), want_dx[out].numpy(), rtol=2e-4)


def test_plain_versions_chunk_invariant():
    """The chunk changes the fold order only: every chunk, one whole-catalog
    chunk included, gives the same loss within f32 noise."""
    x, w, t, _, cap = _problem("cap30")
    xt, wt, tt = map(torch.from_numpy, (x, w, t))
    want = ref.linear_ce_loss_ref(xt, wt, tt, logit_softcap=cap,
                                  chunk=w.shape[0])
    for chunk in (1, 7, CHUNK, 4096):
        _close(ref.linear_ce_loss_ref(xt, wt, tt, logit_softcap=cap,
                                      chunk=chunk).numpy(), want.numpy())
    lse = ref.fused_lse_ref(xt, wt, chunk=7)
    _close(lse.numpy(), torch.logsumexp(xt @ wt.T, -1).numpy())
