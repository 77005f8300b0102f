"""The hand-written CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and
skip without one. This file imports neither JAX nor the JAX package, so
it also runs where only PyTorch is installed; on such a machine run it
without the repository's JAX-importing ``conftest.py``::

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Integer-valued inputs make every f32 fold order exact, so the kernel and
the plain version must agree bit for bit (values, ids, tie order,
``ID_PAD`` tails); generic floats agree within ``1e-5·max|score|`` with
ids equal wherever neighbouring scores are further apart than that.
"""
import pytest
import torch

from repro_torch.kernels import mips_topk as kernel
from repro_torch.kernels import ops, ref
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
        kernel.mips_topk(q, torch.zeros(400, 8, device=dev), 300)  # k > 256
    with pytest.raises(ValueError):
        kernel.mips_topk(torch.zeros(4, 300, device=dev),
                         torch.zeros(20, 300, device=dev), 3)
    with pytest.raises(ValueError):
        kernel.mips_topk(q, y.cpu(), 3)
    with pytest.raises(TypeError):  # bool masks only
        kernel.mips_topk(q, y, 3, valid=torch.ones(20, dtype=torch.int32,
                                                    device=dev))
