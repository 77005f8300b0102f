"""The arithmetic of the 3xTF32 in-bucket SCE backward, on the CPU.

``csrc/sce_gather.cu``'s dX and dY kernels (behind ``sce_gather_loss``,
``sce_gather_plse`` and their ``sce_bucket`` twins) take both products on
the tensor cores in 3xTF32 (``csrc/tf32x3_tile.cuh``): each f32 input is
split into ``hi = tf32(a)`` and ``lo = tf32(a − hi)``, each product is
``lo·hi + hi·lo + hi·hi``, and each k16 step of a sum starts from zero and
is added to an f32 total. Between the two products the cotangent
``gw = exp(min(l − lse, 44))·cap′·g`` is formed in f32, 0 by a select
where a candidate is masked (invalid, colliding with the target) — never
by a product, since a partial-LSE row with no unmasked candidate has
``lse = −1e30`` and its exp would be inf. A CUDA kernel has no CPU mode,
so this file holds a plain, test-only model of that arithmetic
(``_tf32x3_backward``) against the plain versions, as evidence before the
card that the chip tolerance holds:

- on small versions of the cases of ``test_torch_cuda.py``'s
  ``test_sce_gather_kernels_match_plain`` (ragged, d 33, cap 30 at
  x_b × 8, every bucket on the same candidate rows, d 256) and
  ``test_sce_gather_plse_kernels_match_plain`` (a share of the candidates
  at ``cand = −1``, bucket 0 owning none), and at the trainer's logit
  scale (x_b 3·randn): dX and dY within ``1e-5·max|grad| + 2e-4·|grad|``
  of autograd through ``sce_gather_loss_ref`` / ``sce_gather_plse_ref``
  evaluated in f64, with the lse (plse) of the f32 forward as the kernels
  get it;
- dX exactly 0 on every row with no unmasked candidate;
- against the JAX kernels' VJP (``repro.kernels.ops.sce_gather_loss`` and
  ``sce_gather_plse``, interpret mode) on two cases;
- the card-free copy of the backward's launch plan
  (``sce_prefetch.bwd_plan``) fits a block's 232,448 bytes of shared
  memory for every d ≤ 256, and two blocks share an SM at d = 64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref, sce_prefetch

MAX_EXP = 44.0  # the kernels' cap on exp's argument


def _split(a):
    hi = ref.tf32_round(a)
    return hi, ref.tf32_round(a - hi)


def _mm3(ah, al, bh, bl):
    """Batched ``(…, M, K)·(…, K, N)`` as the kernels take it: per k16
    step the three TF32 products, the small ones first (each product exact
    in f32: 11 by 11 bits), summed from zero and added to the f32 total."""
    out = torch.zeros(*ah.shape[:-1], bh.shape[-1])
    for k in range(0, ah.shape[-1], 16):
        s = slice(k, k + 16)
        out += ((al[..., s] @ bh[..., s, :] + ah[..., s] @ bl[..., s, :])
                + ah[..., s] @ bh[..., s, :])
    return out


def _tf32x3_backward(x_b, y, idx, tgt, cand, lse, g, cap):
    """``(dX (n_b, b_x, d), dY (C, d))`` in the kernels' arithmetic: the
    logits from the split rows (k16 steps over the depth), the softcap,
    ``gw`` masked by a select before it can overflow, split again, and the
    second products (k16 steps over the candidates for dX, over the
    positions for dY); dY's rows summed into the catalog."""
    rows = idx.long().clamp(0, y.shape[0] - 1)
    y_b = y[rows]
    xh, xl = _split(x_b)
    yh, yl = _split(y_b)
    s = _mm3(xh, xl, yh.transpose(1, 2), yl.transpose(1, 2))
    lg = s if cap is None else cap * torch.tanh(s / cap)
    masked = (cand[:, None, :] < 0) | (cand[:, None, :] == tgt[:, :, None])
    p = torch.exp(torch.clamp(lg - lse[..., None], max=MAX_EXP))
    if cap is not None:
        p = p * (1.0 - (lg / cap) ** 2)
    gw = torch.where(masked, 0.0, p * g[..., None])
    gh, gl = _split(gw)
    dx = _mm3(gh, gl, yh, yl)
    dy_b = _mm3(gh.transpose(1, 2), gl.transpose(1, 2), xh, xl)
    dy = torch.zeros_like(y).index_add_(0, rows.reshape(-1),
                                        dy_b.reshape(-1, y.shape[1]))
    return dx, dy


def _close(got, want, rtol=2e-4):
    assert got.shape == want.shape and torch.isfinite(got).all()
    tol = 1e-5 * want.abs().max().item()
    err = (got - want).abs()
    assert (err <= tol + rtol * want.abs()).all(), err.max().item()


# (n_b, b_x, b_y, d, C, cap, x scale, same rows, owned share), C cut down
CASES = {
    "small": (2, 16, 24, 8, 100, None, 1.0, False, 1.0),
    "ragged": (3, 100, 50, 16, 257, None, 1.0, False, 1.0),
    "d4": (1, 8, 40, 4, 40, None, 1.0, False, 1.0),
    "d33_cap30": (5, 23, 50, 33, 300, 30.0, 8.0, False, 1.0),
    "same_rows": (4, 70, 64, 64, 200, None, 1.0, True, 1.0),
    "d256_cap30": (3, 64, 48, 256, 500, 30.0, 8.0, False, 1.0),
    "trainer_scale": (4, 64, 64, 64, 2_000, None, 3.0, False, 1.0),
    "plse_d33_cap30_half": (5, 23, 50, 33, 300, 30.0, 8.0, False, 0.5),
    "plse_d256_quarter": (3, 64, 48, 256, 500, None, 1.0, False, 0.25),
}


def _problem(name, plse):
    """The CUDA tests' inputs at this size, from numpy: distinct rows per
    bucket (or the same rows for every bucket), a collision in slot 0 and
    an invalid last slot; for the partial LSE a share ``owned`` of the
    candidates kept and bucket 0 owning none."""
    n_b, b_x, b_y, d, c, cap, scale, same, owned = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + plse)
    x_b = (scale * rng.standard_normal((n_b, b_x, d))).astype(np.float32)
    y = rng.standard_normal((c, d)).astype(np.float32)
    if same:
        idx = np.tile(rng.permutation(c)[:b_y], (n_b, 1))
    else:
        idx = np.stack([rng.permutation(c)[:b_y] for _ in range(n_b)])
    idx = idx.astype(np.int32)
    tgt = rng.integers(0, c, (n_b, b_x)).astype(np.int32)
    cand = idx.copy()
    if not same:
        cand[:, 0] = tgt[:, 0]
        cand[:, -1] = -1
    if plse:
        cand = np.where(rng.random(cand.shape) < owned, cand, -1)
        cand[0] = -1
    pos = rng.standard_normal((n_b, b_x)).astype(np.float32)
    if cap is not None:
        pos = (cap * np.tanh(pos * 20.0 / cap)).astype(np.float32)
    g = rng.random((n_b, b_x)).astype(np.float32)
    return (*map(torch.from_numpy, (x_b, y, idx, tgt, cand, pos, g)), cap)


def _autograd(plse, x_b, y, idx, tgt, cand, pos, g, cap):
    """The plain version's value and its (dX, dY) by autograd, in the
    inputs' type."""
    leaves = [t.clone().requires_grad_(True) for t in (x_b, y)]
    if plse:
        out = ref.sce_gather_plse_ref(*leaves, idx, tgt, cand, cap)
    else:
        out = ref.sce_gather_loss_ref(*leaves, idx, tgt, cand, pos, cap)
    return out.detach(), torch.autograd.grad((out * g).sum(), leaves)


def _forward_lse(plse, x_b, y, idx, tgt, cand, pos, g, cap):
    """The f32 lse (or plse) the forward kernel hands its backward."""
    out, _ = _autograd(plse, x_b, y, idx, tgt, cand, pos, g, cap)
    return out if plse else out + pos


@pytest.mark.parametrize("plse", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tf32x3_backward_holds_the_chip_tolerance(name, plse):
    x_b, y, idx, tgt, cand, pos, g, cap = _problem(name, plse)
    args = (idx, tgt, cand)
    lse = _forward_lse(plse, x_b, y, *args, pos, g, cap)
    dx, dy = _tf32x3_backward(x_b, y, *args, lse, g, cap)
    _, want = _autograd(plse, x_b.double(), y.double(), *args, pos.double(),
                        g.double(), cap)
    assert want[0].dtype == torch.float64
    _close(dx, want[0].float())
    _close(dy, want[1].float())
    dead = ((cand[:, None, :] < 0)
            | (cand[:, None, :] == tgt[:, :, None])).all(dim=-1)
    assert dead.any() == plse  # bucket 0 owns nothing
    assert (dx[dead] == 0).all()
    if plse:
        assert (lse[dead] == -1e30).all()


# test_torch_sce_gather.py's and test_torch_sce_plse.py's JAX cases
JAX_CASES = {
    "ragged": (3, 100, 50, 16, 257, None),
    "cap30": (2, 16, 24, 8, 100, 30.0),
}


@pytest.mark.parametrize("plse", [False, True])
@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_tf32x3_backward_matches_the_jax_kernel(name, plse):
    n_b, b_x, b_y, d, c, cap = JAX_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x_b = (4.0 * rng.standard_normal((n_b, b_x, d))).astype(np.float32)
    y = rng.standard_normal((c, d)).astype(np.float32)
    idx = rng.integers(0, c, (n_b, b_y)).astype(np.int32)
    tgt = rng.integers(0, c, (n_b, b_x)).astype(np.int32)
    cand = idx.copy()
    cand[:, 0] = tgt[:, 0]
    cand[:, -1] = -1
    if plse:
        cand[:, 1::3] = -1
    pos = rng.standard_normal((n_b, b_x)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (n_b, b_x)).astype(np.float32)
    kw = dict(block_bx=16, block_by=16, interpret=True, logit_softcap=cap)

    def f(a, b):
        if plse:
            return jops.sce_gather_plse(a, b, idx, tgt, cand, **kw)
        return jops.sce_gather_loss(a, b, idx, tgt, cand, pos, **kw)

    out, vjp = jax.vjp(f, jnp.asarray(x_b), jnp.asarray(y))
    want_dx, want_dy = (torch.from_numpy(np.array(a))
                        for a in vjp(jnp.asarray(g)))
    out = torch.from_numpy(np.array(out))
    lse = out if plse else out + torch.from_numpy(pos)
    dx, dy = _tf32x3_backward(*map(torch.from_numpy, (x_b, y, idx, tgt,
                                                      cand)),
                              lse, torch.from_numpy(g), cap)
    _close(dx, want_dx)
    _close(dy, want_dy)


def test_backward_launch_plan_fits_the_card():
    for d in range(1, sce_prefetch.MAX_D + 1):
        warps, smem = sce_prefetch.bwd_plan(d)
        assert warps in (1, 2, 4)
        assert smem <= sce_prefetch.MAX_SMEM
        assert sce_prefetch.planned_smem(d) == max(smem,
                                                   sce_prefetch.fwd_smem(d))
        assert sce_prefetch.planned_smem(d) <= sce_prefetch.MAX_SMEM
    # d = 64: two blocks of four warps share an SM (228 KB, 1 KB a block)
    assert sce_prefetch.bwd_plan(64) == (4, 107_904)
    assert 2 * (107_904 + 1024) <= 233_472
