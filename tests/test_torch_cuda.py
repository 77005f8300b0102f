"""The hand-written CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and
skip without one. This file imports neither JAX nor the JAX package, so
it also runs where only PyTorch is installed; on such a machine run it
without the repository's JAX-importing ``conftest.py``::

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

``mips_topk``: integer-valued inputs make every f32 fold order exact, so
the kernel and the plain version must agree bit for bit (values, ids, tie
order, ``ID_PAD`` tails); generic floats agree within ``1e-5·max|score|``
with ids equal wherever neighbouring scores are further apart than that.

``sce_gather`` (forward, dX, dY): losses within ``1e-5·max|loss|``,
gradients within ``rtol 2e-4``, ``atol 1e-5·max|grad|`` of autograd
through the plain version (f32 sums in another order; dY's atomics add in
an order that changes from run to run), and rows of dY that no bucket
selected exactly 0.
"""
import pytest
import torch

from repro_torch.kernels import mips_topk as kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sce_prefetch
from repro_torch.kernels.topk_merge import ID_PAD

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch import resolve_device

    return resolve_device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _ints(g, dev, *shape):
    return torch.randint(-2, 3, shape, generator=g, device=dev).float()


def _assert_match(got, want, scale, exact):
    gv, gi = got
    wv, wi = want
    assert gi.dtype == torch.int32 and gv.shape == wv.shape
    if exact:
        assert torch.equal(gv, wv) and torch.equal(gi, wi)
        return
    tol = 1e-5 * scale
    assert (gv - wv).abs().max().item() <= tol
    inf = torch.full_like(wv[:, :1], float("inf"))
    prv = torch.cat([inf, wv[:, :-1]], 1)
    nxt = torch.cat([wv[:, 1:], -inf], 1)
    isolated = ((prv - wv) > tol) & ((wv - nxt) > tol)
    assert torch.equal(gi[isolated], wi[isolated])


@pytest.mark.parametrize("n_q,c,d,k,integer,valid,id_offset", [
    (8, 5_000, 64, 10, True, "window", 0),
    (33, 4_100, 64, 10, False, "window", 0),
    (70, 1_037, 48, 17, True, None, 12),
    (5, 7, 64, 12, True, None, 0),
    (9, 500, 64, 10, True, "starved", 1_000),
    (40, 3_000, 256, 256, False, None, 0),
    (40, 3_000, 128, 256, True, "random", 5),
    # d % 4 != 0: the 4-byte tile loader and the zeroed depth padding.
    (37, 1_100, 33, 10, True, "window", 7),
    (12, 2_000, 63, 20, False, "random", 3),
    # The selections of SCE training (b_x = 320, b_y = 256) and the cap.
    (64, 3_000, 64, 320, True, "random", 0),
    (40, 5_000, 64, 320, False, "random", 0),
    (20, 2_000, 64, 512, True, "window", 0),
    (9, 500, 64, 320, True, "starved", 0),
])
def test_mips_topk_kernel_matches_plain(dev, n_q, c, d, k, integer, valid,
                                        id_offset):
    g = _gen(dev, n_q * 7 + c)
    if integer:
        q, y = _ints(g, dev, n_q, d), _ints(g, dev, c, d)
    else:
        q = torch.randn(n_q, d, generator=g, device=dev)
        y = torch.randn(c, d, generator=g, device=dev)
    vm = None
    if valid == "window":
        ar = torch.arange(c, device=dev)
        vm = (ar >= 1) & (ar < c - 9)
    elif valid == "starved":
        vm = torch.zeros(c, dtype=torch.bool, device=dev)
        vm[:: c // 6][:6] = True
    elif valid == "random":
        vm = torch.rand(c, generator=g, device=dev) > 0.3
    before = kernel.mips_topk.launches
    got = ops.mips_topk(q, y, k, valid=vm, id_offset=id_offset)
    torch.cuda.synchronize()
    assert kernel.mips_topk.launches == before + 1
    want = ref.mips_topk_ref(q, y, k, valid=vm, id_offset=id_offset)
    _assert_match(got, want, (q @ y.T).abs().max().item(), integer)
    if valid == "starved":
        assert (got[1][:, 6:] == ID_PAD).all()


def test_mips_topk_kernel_misaligned_catalog(dev):
    """A catalog view 4 bytes past a 16-byte boundary (d % 4 == 0) takes
    the 4-byte tile loader."""
    g = _gen(dev, 2)
    q = _ints(g, dev, 9, 64)
    y = _ints(g, dev, 700 * 64 + 1)[1:].view(700, 64)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    got = kernel.mips_topk(q, y, 10, id_offset=4)
    want = ref.mips_topk_ref(q, y, 10, id_offset=4)
    _assert_match(got, want, (q @ y.T).abs().max().item(), True)


def test_mips_topk_kernel_is_deterministic(dev):
    g = _gen(dev, 1)
    q = torch.randn(32, 64, generator=g, device=dev)
    y = torch.randn(20_000, 64, generator=g, device=dev)
    a = kernel.mips_topk(q, y, 10)
    b = kernel.mips_topk(q, y, 10)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_mips_topk_kernel_raises_on_what_it_does_not_take(dev):
    q = torch.zeros(4, 8, device=dev)
    y = torch.zeros(20, 8, device=dev)
    with pytest.raises(TypeError):
        kernel.mips_topk(q.double(), y.double(), 3)
    with pytest.raises(ValueError):
        kernel.mips_topk(q, torch.zeros(8, 20, device=dev).T, 3)
    with pytest.raises(ValueError):
        kernel.mips_topk(q, torch.zeros(700, 8, device=dev), 600)  # k > 512
    with pytest.raises(ValueError):
        kernel.mips_topk(torch.zeros(4, 300, device=dev),
                         torch.zeros(20, 300, device=dev), 3)
    with pytest.raises(ValueError):
        kernel.mips_topk(q, y.cpu(), 3)
    with pytest.raises(TypeError):  # bool masks only
        kernel.mips_topk(q, y, 3, valid=torch.ones(20, dtype=torch.int32,
                                                    device=dev))


# ---------------------------------------------------------------------------
# sce_gather: forward, dX, dY
# ---------------------------------------------------------------------------
def _gather_problem(dev, seed, n_b, b_x, b_y, d, c, *, same=False):
    """x_b, y, idx_y, tgt_b, cand_ids, pos on the card: distinct rows per
    bucket (as a top-k gives them), a collision in slot 0 and an invalid
    last slot; with ``same`` every bucket takes the same rows."""
    g = _gen(dev, seed)
    x_b = torch.randn(n_b, b_x, d, generator=g, device=dev)
    y = torch.randn(c, d, generator=g, device=dev)
    if same:
        idx = torch.randperm(c, generator=g, device=dev)[:b_y].repeat(n_b, 1)
    else:
        idx = torch.stack([torch.randperm(c, generator=g, device=dev)[:b_y]
                           for _ in range(n_b)])
    idx = idx.to(torch.int32)
    tgt = torch.randint(0, c, (n_b, b_x), generator=g, device=dev,
                        dtype=torch.int32)
    cand = idx.clone()
    if not same:
        cand[:, 0] = tgt[:, 0]
        cand[:, -1] = -1
    pos = torch.randn(n_b, b_x, generator=g, device=dev)
    return x_b, y, idx, tgt, cand, pos


def _close(got, want, rtol=0.0):
    assert got.shape == want.shape and torch.isfinite(got).all()
    tol = 1e-5 * want.abs().max().item()
    assert ((got - want).abs() <= tol + rtol * want.abs()).all(), \
        (got - want).abs().max().item()


@pytest.mark.parametrize("shape,cap,same", [
    ((2, 16, 24, 8, 100), None, False),
    ((3, 100, 50, 16, 257), None, False),  # ragged everything
    ((1, 8, 40, 4, 40), None, False),
    ((5, 23, 50, 33, 300), 30.0, False),  # d % 4 != 0, softcap
    ((4, 70, 64, 64, 200), None, True),  # every bucket the same rows
    ((3, 64, 48, 256, 500), 30.0, False),  # d at the kernel's cap
    ((320, 320, 256, 64, 173_520), None, False),  # the training shape
])
def test_sce_gather_kernels_match_plain(dev, shape, cap, same):
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, sum(shape), *shape,
                                                  same=same)
    if cap is not None:
        x_b = x_b * 8.0
        pos = cap * torch.tanh(pos * 20.0 / cap)
    g = torch.rand(pos.shape, generator=_gen(dev, 9), device=dev)
    before = (sce_prefetch.sce_gather_fwd.launches,
              sce_prefetch.sce_gather_dx.launches,
              sce_prefetch.sce_gather_dy.launches)
    leaves = [t.clone().requires_grad_(True) for t in (x_b, y, pos)]
    loss = ops.sce_gather_loss(leaves[0], leaves[1], idx, tgt, cand,
                               leaves[2], logit_softcap=cap)
    got = torch.autograd.grad((loss * g).sum(), leaves)
    torch.cuda.synchronize()
    assert (sce_prefetch.sce_gather_fwd.launches,
            sce_prefetch.sce_gather_dx.launches,
            sce_prefetch.sce_gather_dy.launches) == tuple(
                n + 1 for n in before)
    plain = [t.clone().requires_grad_(True) for t in (x_b, y, pos)]
    want_loss = ref.sce_gather_loss_ref(plain[0], plain[1], idx, tgt, cand,
                                        plain[2], cap)
    want = torch.autograd.grad((want_loss * g).sum(), plain)
    _close(loss.detach(), want_loss.detach())
    for a, b in zip(got, want):
        _close(a, b, rtol=2e-4)
    touched = torch.zeros(y.shape[0], dtype=torch.bool, device=dev)
    touched[idx.long().reshape(-1)] = True
    assert (got[1][~touched] == 0).all()


def test_sce_gather_forward_is_deterministic(dev):
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 3, 8, 70, 90, 64,
                                                  1_000)
    a = sce_prefetch.sce_gather_fwd(x_b, y, idx, tgt, cand, pos)
    b = sce_prefetch.sce_gather_fwd(x_b, y, idx, tgt, cand, pos)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_sce_gather_raises_on_what_it_does_not_take(dev):
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 4, 2, 16, 24, 8, 100)
    with pytest.raises(TypeError):
        sce_prefetch.sce_gather_fwd(x_b, y, idx.long(), tgt, cand, pos)
    with pytest.raises(TypeError):
        sce_prefetch.sce_gather_fwd(x_b.double(), y.double(), idx, tgt, cand,
                                    pos)
    with pytest.raises(ValueError):
        sce_prefetch.sce_gather_fwd(x_b.transpose(0, 1), y, idx, tgt, cand,
                                    pos)
    with pytest.raises(ValueError):
        sce_prefetch.sce_gather_fwd(x_b, y.cpu(), idx, tgt, cand, pos)
    with pytest.raises(ValueError):
        big = torch.zeros(2, 16, 300, device=dev)
        sce_prefetch.sce_gather_fwd(big, torch.zeros(100, 300, device=dev),
                                    idx, tgt, cand, pos)
