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
Above k = 32 (the threshold, collect and select chain) the same on its
adversarial inputs — the best columns in one residue of the threshold
pass's tiles, all-equal scores, fewer valid columns than k, k = C,
k = 512 — and with a collect buffer small enough that a row overflows
into the split sweep; two launches repeat bit for bit.

``sce_gather`` (forward, dX, dY): losses within ``1e-5·max|loss|``,
gradients within ``rtol 2e-4``, ``atol 1e-5·max|grad|`` of autograd
through the plain version (f32 sums in another order; dY's atomics add in
an order that changes from run to run), and rows of dY that no bucket
selected exactly 0. dX and dY run in 3xTF32 on the tensor cores: at the
trainer's logit scale (x_b 3·randn) they hold the plain version evaluated
in f64 at the same tolerances, and given their forward's lse they are no
farther from their formula in f64 than the f32 plain formula is; a
loss bucket whose candidates are all masked has loss and dX exactly 0 and
adds nothing to dY; the wrapper's copy of their launch plan equals the
library's.

``sce_gather_plse`` (the partial LSE and the same dX and dY launches,
counted apart): the same tolerances, rows with no unmasked candidate
exactly ``−1e30`` with exactly 0 in dX; forward and dX repeat bit for
bit.

``eval_fused`` / ``eval_tgt_gather``: on integer-valued inputs ids, vals,
``gt``, ``eq`` and ``tgt`` equal the plain version's bit for bit and the
LSE (``m + log s``) within ``1e-5`` relative (exp folds in another
order); on floats values within ``1e-5·max|score|``, ids equal where
neighbouring values are further apart, ranks inside the band a dense f64
oracle allows and the LSE within ``1e-5`` relative. On every input a
target in the top-k carries exactly ``tgt``, and ``eq >= 1`` on every row
whose target is a valid column.

``linear_ce`` (forward, dX, dW; ``linear_ce_loss`` with the positive
plucked in the sweep, and ``fused_lse`` without it): losses and lse within
``1e-5·max|value|``, gradients within ``1e-5·max|grad|`` plus
``2e-4·|grad|`` of the plain versions (``linear_ce_loss_ref`` and the
chunked backward ``linear_ce_dx_ref`` / ``linear_ce_dw_ref``; exp sums
fold in another order). Every kernel repeats bit for bit, and ``ops``
raises on a mix of CPU and CUDA tensors. The forward, dX and dW/dY run in
3xTF32 on the tensor cores: the same tolerances at the trainer's logit
scale (x 3·randn, d 64, many catalog splits) against the plain version
evaluated in f64; the forward at every shape of its launch plan (d 1 to
256, a last split that holds only a 5-column tile); a cotangent that is
only the
one-hot (fused: the target's logit far above the rest, g = 1; linear: an
lse far above every logit, so p = 0) gives dX = ±w[target] and dW/dY the
sums of x over each target's positions exactly, as the plain version —
the case that a wrong fragment order cannot pass; the split kernel's
(hi, lo) planes equal ``ref.tf32x3_planes_ref`` bit for bit (values
built bit by bit included); a step splits once, in the forward, and
the backward hands the same planes to both gradients; the wrapper's
copies of the forward's and the backward's launch plans equal the
library's at every depth; and an lse more than 44 below a logit, where
the kernels cap exp's argument (their one deviation from the plain
version), holds the capped formula.

``sce_bucket`` (forward, dX, dY over pre-gathered candidates, and the
partial LSE): the tolerances of ``sce_gather``; its forward and dX equal
``sce_gather``'s bit for bit on ``y_b = y[idx]`` (the same tile walk),
and its dY — written, not added — repeats bit for bit.

``eval_topk`` / ``eval_tgt_scores``: as ``eval_fused``, without the
self-column rule; ``eval_tgt_scores`` is bit for bit the column
``eval_topk`` sweeps (``eq >= 1`` on every row whose target is valid).

The kernel guard: every conformance canary passes on the card, and a
broken kernel raises ``KernelConformanceError`` under ``warn``. The
``dev`` fixture runs the canaries once before any test counts launches,
so a test's launch counts hold its own launches only.
"""
import pytest
import torch

from repro_torch.kernels import eval_fused as eval_kernel
from repro_torch.kernels import eval_topk as topk_kernel
from repro_torch.kernels import fused_ce, guard, linear_sce
from repro_torch.kernels import mips_topk as kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sce_bucket, sce_prefetch
from repro_torch.kernels.topk_merge import ID_PAD

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch import resolve_device

    dev = resolve_device("cuda")
    guard.run_conformance(device=dev)  # memoized: canaries run once
    return dev


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


def _select_problem(dev, name, n_q, c, d, k):
    """Integer inputs of one adversarial case of the k > 32 chain."""
    g = _gen(dev, n_q * 11 + c + k)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    sp = kernel.select_plan(n_q, c, d, k, n_sm)
    q, y = _ints(g, dev, n_q, d), _ints(g, dev, c, d)
    valid = None
    if name.startswith("clustered"):
        # positive queries, boosted catalog rows in the tiles t with
        # t % period == residue: one split holds every row's best
        residue = 1 if name == "clustered_sampled" else sp.n_split + 1
        q = q.abs() + 1
        hot = (torch.arange(c, device=dev) // kernel.TILE_C) % sp.period \
            == residue
        y[hot] = torch.randint(3, 6, (int(hot.sum()), d), generator=g,
                               device=dev).float()
    elif name == "all_equal":
        q, y = torch.ones_like(q), torch.ones_like(y)
    elif name == "fewer_valid_than_k":
        valid = torch.zeros(c, dtype=torch.bool, device=dev)
        valid[torch.randperm(c, generator=g, device=dev)[:k // 3]] = True
    elif name in ("k_equals_c", "k512"):
        valid = torch.rand(c, generator=g, device=dev) > 0.3
    return q, y, valid, sp


@pytest.mark.parametrize("name,n_q,c,d,k", [
    ("clustered_sampled", 100, 140_000, 64, 256),
    ("clustered_skipped", 100, 140_000, 64, 256),
    ("all_equal", 70, 8_000, 64, 320),
    ("fewer_valid_than_k", 65, 25_600, 64, 320),
    ("k_equals_c", 33, 400, 48, 400),
    ("k512", 130, 20_000, 64, 512),
])
def test_mips_topk_select_chain_matches_plain(dev, name, n_q, c, d, k):
    q, y, valid, sp = _select_problem(dev, name, n_q, c, d, k)
    if name == "clustered_skipped":
        assert sp.period > sp.n_split  # the threshold pass samples
    got = ops.mips_topk(q, y, k, valid=valid, id_offset=3)
    torch.cuda.synchronize()
    want = ref.mips_topk_ref(q, y, k, valid=valid, id_offset=3)
    _assert_match(got, want, 0.0, True)
    counts = kernel.mips_topk.last_counts
    assert counts.shape == (n_q,) and bool((counts >= min(k, c)).all()) \
        == (valid is None or int(valid.sum()) >= k)
    if name == "fewer_valid_than_k":
        assert (got[1][:, k // 3:] == ID_PAD).all()


def test_mips_topk_select_overflow_row_takes_the_split_sweep(dev):
    """A row of all-equal scores collects ≈ 1.6k entries; with kcap 48
    it overflows and the split sweep finishes it, while the other rows
    take the select; both agree with the plain version bit for bit."""
    g = _gen(dev, 21)
    q, y = _ints(g, dev, 40, 64), _ints(g, dev, 5_000, 64)
    q[3] = 0.0
    valid = torch.rand(5_000, generator=g, device=dev) > 0.1
    got = kernel.mips_topk(q, y, 40, valid=valid, id_offset=100, kcap=48)
    counts = kernel.mips_topk.last_counts.cpu()
    want = ref.mips_topk_ref(q, y, 40, valid=valid, id_offset=100)
    _assert_match(got, want, 0.0, True)
    assert counts[3] > 48 and int((counts <= 48).sum()) >= 20


def test_mips_topk_select_chain_is_deterministic(dev):
    g = _gen(dev, 22)
    q = torch.randn(200, 64, generator=g, device=dev)
    y = torch.randn(60_000, 64, generator=g, device=dev)
    for k in (256, 320):
        a = kernel.mips_topk(q, y, k)
        b = kernel.mips_topk(q, y, k)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        want = ref.mips_topk_ref(q, y, k)
        _assert_match(a, want, (q @ y.T).abs().max().item(), False)


def test_mips_topk_kernel_raises_on_what_it_does_not_take(dev):
    q = torch.zeros(4, 8, device=dev)
    y = torch.zeros(20, 8, device=dev)
    with pytest.raises(TypeError):
        kernel.mips_topk(q.double(), y.double(), 3)
    with pytest.raises(ValueError):
        kernel.mips_topk(q, torch.zeros(8, 20, device=dev).T, 3)
    with pytest.raises(ValueError):
        kernel.mips_topk(q, torch.zeros(700, 8, device=dev), 600)  # k > 512
    with pytest.raises(ValueError):  # a collect buffer below k
        kernel.mips_topk(q, torch.zeros(700, 8, device=dev), 40, kcap=39)
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


def _max_err(got, want):
    return (got.double() - want).abs().max().item()


def _gather_grads_given_lse(x_b, y, idx, tgt, cand, lse, g):
    """The plain formula of the dX and dY kernels for a given lse, in the
    inputs' type: ``gw = exp(l − lse)·g``, 0 where masked (a select),
    ``dX = gw·y_b`` and ``dY`` the scatter-add of ``gwᵀ·x_b`` into the
    candidates' catalog rows."""
    rows = idx.long().clamp(0, y.shape[0] - 1)
    y_b = y[rows]
    logits = torch.einsum("nxd,nyd->nxy", x_b, y_b)
    masked = (cand[:, None, :] < 0) | (cand[:, None, :] == tgt[:, :, None])
    gw = torch.where(masked, 0.0,
                     torch.exp(logits - lse[..., None]) * g[..., None])
    dy = torch.zeros_like(y).index_add_(
        0, rows.reshape(-1),
        torch.bmm(gw.transpose(1, 2), x_b).reshape(-1, y.shape[1]))
    return torch.bmm(gw, y_b), dy


@pytest.mark.parametrize("plse", [False, True])
def test_sce_gather_backward_at_the_trainer_logit_scale(dev, plse):
    """x_b at 3·randn (the trainer's logit scale), the loss or the partial
    LSE (half the candidates masked). End to end, dX and dY hold autograd
    through the plain version evaluated in f64 at the f32 tolerance. And
    the dX and dY kernels, given their forward's lse, are no farther from
    their formula evaluated in f64 than the f32 plain formula is: the
    3xTF32 products, each k16 step from zero, round like f32 FMAs."""
    shape = (16, 320, 256, 64, 20_000)
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 31, *shape)
    x_b = 3.0 * x_b
    pos = (x_b * y[tgt.long()]).sum(-1)
    if plse:
        cand = torch.where(torch.rand(cand.shape, generator=_gen(dev, 32),
                                      device=dev) < 0.5, cand, -1)
    up = torch.rand(shape[:2], generator=_gen(dev, 33), device=dev)

    def grads(fn, dtype):
        leaves = [t.to(dtype).requires_grad_(True) for t in (x_b, y)]
        rest = () if plse else (pos.to(dtype),)
        out = fn(leaves[0], leaves[1], idx, tgt, cand, *rest)
        return torch.autograd.grad((out * up.to(dtype)).sum(), leaves)

    kernel = ops.sce_gather_plse if plse else ops.sce_gather_loss
    plain = ref.sce_gather_plse_ref if plse else ref.sce_gather_loss_ref
    got = grads(kernel, torch.float32)
    exact = grads(plain, torch.float64)
    for a, b in zip(got, exact):
        _close(a, b.float(), rtol=2e-4)

    args = (x_b, y, idx, tgt, cand)
    if plse:
        lse = sce_prefetch.sce_gather_plse_fwd(*args)
        got = (sce_prefetch.sce_gather_plse_dx(*args, lse, up),
               sce_prefetch.sce_gather_plse_dy(*args, lse, up))
    else:
        lse = sce_prefetch.sce_gather_fwd(*args, pos)[1]
        got = (sce_prefetch.sce_gather_dx(*args, lse, up),
               sce_prefetch.sce_gather_dy(*args, lse, up))
    exact = _gather_grads_given_lse(x_b.double(), y.double(), idx, tgt, cand,
                                    lse.double(), up.double())
    f32 = _gather_grads_given_lse(x_b, y, idx, tgt, cand, lse, up)
    for a, b, c in zip(got, exact, f32):
        _close(a, b.float(), rtol=2e-4)
        assert _max_err(a, b) <= _max_err(c, b), (_max_err(a, b),
                                                 _max_err(c, b))


def test_sce_gather_loss_bucket_with_every_candidate_masked(dev):
    """A bucket of the loss whose candidates are all masked: its lse is
    the positive alone, its dX rows exactly 0 and its candidates add
    nothing to dY."""
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 34, 3, 70, 90, 33,
                                                  400)
    cand[1] = -1
    g = torch.rand(pos.shape, generator=_gen(dev, 35), device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (x_b, y, pos)]
    loss = ops.sce_gather_loss(leaves[0], leaves[1], idx, tgt, cand,
                               leaves[2])
    got = torch.autograd.grad((loss * g).sum(), leaves)
    plain = [t.clone().requires_grad_(True) for t in (x_b, y, pos)]
    want_loss = ref.sce_gather_loss_ref(plain[0], plain[1], idx, tgt, cand,
                                        plain[2])
    want = torch.autograd.grad((want_loss * g).sum(), plain)
    _close(loss.detach(), want_loss.detach())
    for a, b in zip(got, want):
        _close(a, b, rtol=2e-4)
    assert (loss.detach()[1] == 0).all() and (got[0][1] == 0).all()
    only = torch.ones(y.shape[0], dtype=torch.bool, device=dev)
    only[idx[[0, 2]].long().reshape(-1)] = False
    assert (got[1][only] == 0).all()


def test_sce_gather_backward_plan_equals_the_library(dev):
    """The guard's preflight trusts ``sce_prefetch.bwd_plan``, the
    wrapper's copy of the source's dX / dY launch plan: it must equal the
    built library's at every depth the kernels take."""
    for d in (4, 33, 64, 256):
        assert sce_prefetch.bwd_plan(d) == sce_prefetch.library_bwd_plan(d)
    with pytest.raises(ValueError):
        sce_prefetch.library_bwd_plan(sce_prefetch.MAX_D + 1)


# ---------------------------------------------------------------------------
# sce_gather_plse: the partial LSE, its dX and dY
# ---------------------------------------------------------------------------
def _plse_launches():
    return (sce_prefetch.sce_gather_plse_fwd.launches,
            sce_prefetch.sce_gather_plse_dx.launches,
            sce_prefetch.sce_gather_plse_dy.launches)


@pytest.mark.parametrize("shape,cap,owned", [
    ((2, 16, 24, 8, 100), None, 1.0),
    ((5, 23, 50, 33, 300), 30.0, 0.5),  # ragged, d % 4 != 0, softcap
    ((3, 64, 48, 256, 500), None, 0.25),
    ((320, 320, 256, 64, 43_380), None, 0.25),  # a shard of 4 at training
])
def test_sce_gather_plse_kernels_match_plain(dev, shape, cap, owned):
    """Forward, dX and dY against autograd through the plain version, with
    a share ``owned`` of the candidates kept (the rest ``cand = −1``, as
    another shard's in the exact mode), bucket 0 owning none: its rows
    are −1e30 (finite) with exactly 0 in dX."""
    x_b, y, idx, tgt, cand, _ = _gather_problem(dev, sum(shape) + 1, *shape)
    g = _gen(dev, 11)
    keep = torch.rand(cand.shape, generator=g, device=dev) < owned
    cand = torch.where(keep, cand, -1)
    cand[0] = -1
    if cap is not None:
        x_b = x_b * 8.0
    up = torch.rand(shape[:2], generator=g, device=dev)
    before = _plse_launches()
    gather_before = (sce_prefetch.sce_gather_fwd.launches,
                     sce_prefetch.sce_gather_dx.launches,
                     sce_prefetch.sce_gather_dy.launches)
    leaves = [t.clone().requires_grad_(True) for t in (x_b, y)]
    plse = ops.sce_gather_plse(leaves[0], leaves[1], idx, tgt, cand,
                               logit_softcap=cap)
    got = torch.autograd.grad((plse * up).sum(), leaves)
    torch.cuda.synchronize()
    assert _plse_launches() == tuple(n + 1 for n in before)
    assert (sce_prefetch.sce_gather_fwd.launches,
            sce_prefetch.sce_gather_dx.launches,
            sce_prefetch.sce_gather_dy.launches) == gather_before
    plain = [t.clone().requires_grad_(True) for t in (x_b, y)]
    want_plse = ref.sce_gather_plse_ref(plain[0], plain[1], idx, tgt, cand,
                                        cap)
    want = torch.autograd.grad((want_plse * up).sum(), plain)
    plse = plse.detach()
    assert torch.isfinite(plse).all()
    assert (plse[0] == -1e30).all() and (got[0][0] == 0).all()
    live = want_plse.detach() > -1e29
    assert torch.equal(plse[~live], want_plse.detach()[~live])
    _close(plse[live], want_plse.detach()[live])
    for a, b in zip(got, want):
        _close(a, b, rtol=2e-4)
    touched = torch.zeros(y.shape[0], dtype=torch.bool, device=dev)
    touched[idx.long().reshape(-1)] = True
    assert (got[1][~touched] == 0).all()


def test_sce_gather_plse_forward_and_dx_are_deterministic(dev):
    x_b, y, idx, tgt, cand, _ = _gather_problem(dev, 5, 8, 70, 90, 64, 1_000)
    cand[:, ::3] = -1
    a = sce_prefetch.sce_gather_plse_fwd(x_b, y, idx, tgt, cand)
    b = sce_prefetch.sce_gather_plse_fwd(x_b, y, idx, tgt, cand)
    assert torch.equal(a, b)
    g = torch.rand(a.shape, generator=_gen(dev, 6), device=dev)
    assert torch.equal(
        sce_prefetch.sce_gather_plse_dx(x_b, y, idx, tgt, cand, a, g),
        sce_prefetch.sce_gather_plse_dx(x_b, y, idx, tgt, cand, a, g))


# ---------------------------------------------------------------------------
# eval_fused, eval_tgt_gather
# ---------------------------------------------------------------------------
def _eval_problem(dev, seed, n, c, d, integer, id_offset, c_lo, c_hi):
    g = _gen(dev, seed)
    if integer:
        x, y = _ints(g, dev, n, d), _ints(g, dev, c, d)
    else:
        x = torch.randn(n, d, generator=g, device=dev)
        y = torch.randn(c, d, generator=g, device=dev)
    lo = max(c_lo, id_offset)
    t = torch.randint(lo, max(lo + 1, min(c_hi, id_offset + c)), (n,),
                      generator=g, device=dev, dtype=torch.int32)
    # plant three targets at the top of their rows, one outside y's range
    t[:3] = lo + torch.arange(3, device=dev, dtype=torch.int32)
    y[(t[:3] - id_offset).long()] = 2.0 * x[:3]
    t[3] = id_offset + c + 4
    return x, y, t


@pytest.mark.parametrize("n,c,d,k,integer,with_lse,cap,c_lo,c_hi,id_offset", [
    (128, 20_000, 64, 10, True, False, None, 1, 19_990, 0),
    (128, 20_000, 64, 10, False, True, None, 1, 19_990, 0),
    (256, 30_000, 64, 10, False, True, 30.0, 1, 29_990, 0),
    (40, 1_037, 33, 17, True, True, 30.0, 1_003, 1_900, 1_000),  # ragged
    (9, 500, 64, 12, True, True, None, 3, 9, 0),  # k > valid columns
    (33, 3_000, 64, 300, False, False, None, 0, 3_000, 0),  # 16 slots
])
def test_eval_fused_kernel_matches_plain(dev, n, c, d, k, integer, with_lse,
                                         cap, c_lo, c_hi, id_offset):
    x, y, t = _eval_problem(dev, n + c, n, c, d, integer, id_offset, c_lo,
                            c_hi)
    kw = dict(c_lo=c_lo, c_hi=c_hi, id_offset=id_offset, logit_softcap=cap,
              with_lse=with_lse)
    before = (eval_kernel.eval_fused.launches,
              eval_kernel.eval_tgt_gather.launches)
    got = ops.eval_fused(x, y, t, k, **kw)
    torch.cuda.synchronize()
    assert (eval_kernel.eval_fused.launches,
            eval_kernel.eval_tgt_gather.launches) == tuple(
                b + 1 for b in before)
    want = ref.eval_fused_ref(x, y, t, k, **kw)
    vals, ids, gt, eq, tgt, m, s = got
    scores = (x.double() @ y.double().T)
    scale = scores.abs().max().item()
    _assert_match((vals, ids), want[:2], scale, integer)
    if integer:
        for a, b in zip((gt, eq, tgt), want[2:5]):
            assert torch.equal(a, b)
    else:
        assert (tgt - want[4]).abs().max().item() <= 1e-5 * scale
        gid = id_offset + torch.arange(c, device=dev)
        ok = (gid >= c_lo) & (gid < c_hi)
        other = ok[None, :] & (gid[None, :] != t[:, None])
        local = (t.long() - id_offset).clamp(0, c - 1)
        owned = (t >= id_offset) & (t < id_offset + c)
        t64 = torch.where(owned, scores.gather(1, local[:, None])[:, 0], 0.0)
        tol = 1e-5 * scale
        lo = ((scores > t64[:, None] + tol) & other).sum(1)
        hi = ((scores >= t64[:, None] - tol) & other).sum(1)
        rank = gt + (eq - 1).clamp_min(0)
        assert ((rank >= lo) & (rank <= hi)).all()
    if with_lse:
        lse, want_lse = m + torch.log(s), want[5] + torch.log(want[6])
        assert torch.allclose(lse, want_lse, rtol=1e-5, atol=0)
    else:
        assert m is None and s is None
    # the threshold is bit for bit the swept target column
    hit = ids == t[:, None]
    assert hit[:3].any(1).all()
    assert torch.equal(vals[hit], tgt[:, None].expand(-1, k)[hit])
    gid_t = t.long()
    valid_t = (gid_t >= max(c_lo, id_offset)) & (gid_t < min(c_hi,
                                                             id_offset + c))
    assert (eq[valid_t] >= 1).all()


def test_eval_kernels_are_deterministic(dev):
    x, y, t = _eval_problem(dev, 5, 64, 20_000, 64, False, 0, 1, 19_990)
    a = ops.eval_fused(x, y, t, 10, c_lo=1, c_hi=19_990, with_lse=True)
    b = ops.eval_fused(x, y, t, 10, c_lo=1, c_hi=19_990, with_lse=True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_eval_kernels_raise_on_what_they_do_not_take(dev):
    x = torch.zeros(4, 8, device=dev)
    y = torch.zeros(700, 8, device=dev)
    t = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        eval_kernel.eval_fused(x.cpu(), y.cpu(), t.cpu(), 3)
    with pytest.raises(ValueError):
        eval_kernel.eval_fused(x, y.cpu(), t, 3)
    with pytest.raises(ValueError):
        eval_kernel.eval_fused(x.double(), y.double(), t, 3)
    with pytest.raises(ValueError):
        eval_kernel.eval_fused(x, y, t.long(), 3)
    with pytest.raises(ValueError):
        eval_kernel.eval_fused(x, torch.zeros(8, 700, device=dev).T, t, 3)
    with pytest.raises(ValueError):
        eval_kernel.eval_fused(x, y, t, 600)  # k > 512
    with pytest.raises(ValueError):
        eval_kernel.eval_fused(torch.zeros(4, 300, device=dev),
                               torch.zeros(20, 300, device=dev), t, 3)
    with pytest.raises(ValueError):
        eval_kernel.eval_tgt_gather(x, y.cpu(), t)
    with pytest.raises(ValueError):
        eval_kernel.eval_tgt_gather(x, y, t.long())


# ---------------------------------------------------------------------------
# linear_ce: forward, dX, dW (linear_ce_loss) and dY (fused_lse)
# ---------------------------------------------------------------------------
def _ce_problem(dev, seed, n, c, d, *, integer=False, dup=False,
                zero_rows=False):
    """x, w, targets and a cotangent g on the card; ``dup`` sends half the
    rows to the last (ragged) catalog row, ``zero_rows`` zeroes every
    third cotangent."""
    g = _gen(dev, seed)
    if integer:
        x, w = _ints(g, dev, n, d), _ints(g, dev, c, d)
    else:
        x = 3.0 * torch.randn(n, d, generator=g, device=dev)
        w = torch.randn(c, d, generator=g, device=dev)
    t = torch.randint(0, c, (n,), generator=g, device=dev, dtype=torch.int32)
    if dup:
        t[: n // 2] = c - 1
    gr = torch.rand(n, generator=g, device=dev) + 0.5
    if zero_rows:
        gr[::3] = 0.0
    return x, w, t, gr


def _ce_launches():
    return tuple(f.launches for f in (
        linear_sce.linear_ce_fwd, linear_sce.linear_ce_dx,
        linear_sce.linear_ce_dw, fused_ce.fused_lse_fwd,
        fused_ce.fused_lse_dx, fused_ce.fused_lse_dy))


@pytest.mark.parametrize("n,c,d,cap,integer,dup,zero_rows", [
    (70, 1_037, 64, None, False, False, False),  # ragged N and C
    (70, 1_037, 64, 30.0, False, True, True),
    (130, 5_000, 33, None, True, False, False),  # d % 4 != 0, integers
    (64, 3_000, 200, 30.0, False, False, True),  # four depth chunks
    (300, 20_000, 64, None, False, True, True),  # catalog splits
])
@pytest.mark.parametrize("pluck", [True, False])
def test_linear_ce_kernels_match_plain(dev, n, c, d, cap, integer, dup,
                                       zero_rows, pluck):
    """``pluck``: ``ops.linear_ce_loss`` (forward, dX, dW); else
    ``ops.fused_lse`` (forward, dX, dY; the kernels have no cap there)."""
    if not pluck:
        cap = None
    x, w, t, gr = _ce_problem(dev, n + c + d, n, c, d, integer=integer,
                              dup=dup, zero_rows=zero_rows)
    before = _ce_launches()
    leaves = [a.clone().requires_grad_(True) for a in (x, w)]
    out = (ops.linear_ce_loss(*leaves, t, logit_softcap=cap) if pluck
           else ops.fused_lse(*leaves))
    got = torch.autograd.grad((out * gr).sum(), leaves)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_ce_launches(), before)]
    assert moved == ([1, 1, 1, 0, 0, 0] if pluck else [0, 0, 0, 1, 1, 1])
    lse = ref.fused_lse_ref(x, w, logit_softcap=cap)
    want = (ref.linear_ce_loss_ref(x, w, t, logit_softcap=cap) if pluck
            else lse)
    _close(out.detach(), want)
    args = (x, w, t if pluck else None, lse, gr)
    want_dx = ref.linear_ce_dx_ref(*args, logit_softcap=cap)
    want_dw = ref.linear_ce_dw_ref(*args, logit_softcap=cap)
    _close(got[0], want_dx, rtol=2e-4)
    _close(got[1], want_dw, rtol=2e-4)
    if zero_rows:
        assert (got[0][gr == 0] == 0).all()


def test_linear_ce_kernels_are_deterministic(dev):
    """The forward's and dX's split merges and dW's transposed grid have no
    atomics: two launches agree bit for bit."""
    x, w, t, gr = _ce_problem(dev, 6, 300, 20_000, 64, dup=True)
    lse = ref.fused_lse_ref(x, w, logit_softcap=30.0)
    for fn in (lambda: linear_sce.linear_ce_fwd(x, w, t, logit_softcap=30.0),
               lambda: linear_sce.linear_ce_dx(x, w, t, lse, gr,
                                               logit_softcap=30.0),
               lambda: linear_sce.linear_ce_dw(x, w, t, lse, gr,
                                               logit_softcap=30.0),
               lambda: fused_ce.fused_lse_dy(x, w, lse, gr)):
        a, b = fn(), fn()
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)


@pytest.mark.parametrize("pluck", [True, False])
def test_linear_ce_kernels_match_plain_at_the_trainer_scale(dev, pluck):
    """d = 64, x at 3·randn (logits up to ≈ 110), no cap, a catalog long
    enough for many splits of dX and positions for many dW tiles. At this
    scale the f32 plain version itself is off the exact gradient by up to
    0.98 of the tolerance (cuBLAS's f32 logits), so the yardstick is the
    plain version evaluated in f64: the kernel holds it at the usual
    tolerance."""
    x, w, t, gr = _ce_problem(dev, 64, 4_096, 60_000, 64)
    tt = t if pluck else None
    lse = ref.fused_lse_ref(x, w)
    planes = linear_sce.linear_ce_split(x, w)
    if pluck:
        dx = linear_sce.linear_ce_dx(x, w, t, lse, gr, planes=planes)
        dw = linear_sce.linear_ce_dw(x, w, t, lse, gr, planes=planes)
    else:
        dx = fused_ce.fused_lse_dx(x, w, lse, gr, planes=planes)
        dw = fused_ce.fused_lse_dy(x, w, lse, gr, planes=planes)
    torch.cuda.synchronize()
    exact = (x.double(), w.double(), tt, lse.double(), gr.double())
    _close(dx, ref.linear_ce_dx_ref(*exact).float(), rtol=2e-4)
    _close(dw, ref.linear_ce_dw_ref(*exact).float(), rtol=2e-4)


@pytest.mark.parametrize("pluck", [True, False])
def test_linear_ce_one_hot_cotangent_is_exact(dev, pluck):
    """Integer inputs and g = 1. fused (no pluck): x = 8·w[target], whose
    logit is more than 110 above every other (f32's exp is 0 below
    −104), so p is exactly the one-hot and dX = w[target]; linear (pluck): an lse of 1e4 makes every p 0, so
    the cotangent is −onehot and dX = −w[target]. dW/dY[j] is ± the sum of
    x over the positions whose target is j. Every sum is of small
    integers, so the kernel, the plain version and the closed form agree
    bit for bit; a wrong k order in the fragments moves whole rows."""
    n, c, d = 1_000, 5_003, 64
    g = _gen(dev, 81)
    w = _ints(g, dev, c, d)
    t = torch.randint(0, c, (n,), generator=g, device=dev, dtype=torch.int32)
    t[::7] = c - 1  # the ragged tile's last row, many times
    x = 8.0 * w[t.long()]
    logits = x @ w.T
    top2 = logits.topk(2, dim=1).values
    assert (logits.gather(1, t.long()[:, None])[:, 0] == top2[:, 0]).all()
    assert ((top2[:, 0] - top2[:, 1]) > 110).all()
    gr = torch.ones(n, device=dev)
    sign = -1.0 if pluck else 1.0
    lse = (torch.full((n,), 1e4, device=dev) if pluck
           else ref.fused_lse_ref(x, w))
    tt = t if pluck else None
    dx = linear_sce.linear_ce_dx(x, w, tt, lse, gr)
    dw = linear_sce.linear_ce_dw(x, w, tt, lse, gr)
    torch.cuda.synchronize()
    want_dx = sign * w[t.long()]
    want_dw = torch.zeros_like(w).index_add_(0, t.long(), sign * x)
    assert torch.equal(dx, want_dx)
    assert torch.equal(dw, want_dw)
    assert torch.equal(dx, ref.linear_ce_dx_ref(x, w, tt, lse, gr))
    assert torch.equal(dw, ref.linear_ce_dw_ref(x, w, tt, lse, gr))


def test_linear_ce_split_matches_plain_bit_for_bit(dev):
    """The split kernel's planes against ``ref.tf32x3_planes_ref``: random
    values over many binades, d % 16 != 0, and values built bit by bit
    (ties, carries into the exponent, the largest finite, subnormals,
    inf); NaN stays NaN."""
    import numpy as np

    words = np.array([0x3F800FFF, 0x3F801000, 0xBF801000, 0x3F801001,
                      0x3FFFF000, 0x7F7FFFFF, 0xFF7FFFFF, 0x00001000,
                      0x80000FFF, 0x007FF000, 0x7F800000, 0xFF800000,
                      0x00000000, 0x80000000], dtype=np.uint32)
    edge = torch.from_numpy(words.view(np.float32)).to(dev)
    g = _gen(dev, 82)
    x = torch.randn(37, 33, generator=g, device=dev) * torch.exp2(
        torch.randint(-40, 40, (37, 33), generator=g, device=dev).float())
    x[0, :edge.numel()] = edge
    x[1, 0] = float("nan")
    w = torch.randn(50, 33, generator=g, device=dev)
    before = linear_sce.linear_ce_split.launches
    xp, wp = linear_sce.linear_ce_split(x, w)
    torch.cuda.synchronize()
    assert linear_sce.linear_ce_split.launches - before == 1
    for got, a in ((xp, x), (wp, w)):
        want = ref.tf32x3_planes_ref(a)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32))


@pytest.mark.parametrize("pluck", [True, False])
def test_linear_ce_backward_splits_once_for_both_gradients(dev, pluck):
    """One split per step: the forward splits x and w, and the backward
    hands the same planes to both gradients without splitting again."""
    x, w, t, gr = _ce_problem(dev, 83, 300, 20_000, 64)
    leaves = [a.clone().requires_grad_(True) for a in (x, w)]
    before = linear_sce.linear_ce_split.launches, _ce_launches()
    out = (ops.linear_ce_loss(*leaves, t) if pluck
           else ops.fused_lse(*leaves))
    split_fwd = linear_sce.linear_ce_split.launches - before[0]
    torch.autograd.grad((out * gr).sum(), leaves)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_ce_launches(), before[1])]
    assert split_fwd == 1
    assert linear_sce.linear_ce_split.launches - before[0] == 1
    assert moved == ([1, 1, 1, 0, 0, 0] if pluck else [0, 0, 0, 1, 1, 1])


@pytest.mark.parametrize("pluck", [True, False])
def test_linear_ce_forward_matches_plain_at_the_trainer_scale(dev, pluck):
    """The forward (3xTF32 on the tensor cores) at d = 64, x at 3·randn
    (logits up to ≈ 110), no cap, a catalog long enough for many splits:
    the loss and lse within ``1e-5·max|want|`` of the plain version
    evaluated in f64. Rows whose target lies outside ``[0, C)`` (−1, and
    C + 3, inside the plain version's last chunk, where it plucks the
    masked −1e30 as the JAX kernel does) pluck 0, as the kernels promise:
    their loss is exactly the lse."""
    n, c = 4_096, 60_000
    x, w, t, _ = _ce_problem(dev, 85, n, c, 64)
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    out[::97] = out[1::97] = True
    t[::97] = -1
    t[1::97] = c + 3
    want_lse = ref.fused_lse_ref(x.double(), w.double())
    assert want_lse.dtype == torch.float64
    planes = linear_sce.linear_ce_split(x, w)
    if pluck:
        loss, lse = linear_sce.linear_ce_fwd(x, w, t, planes=planes)
        want = ref.linear_ce_loss_ref(x.double(), w.double(), t)
        _close(loss[~out], want[~out].float())
        assert torch.equal(loss[out], lse[out])
    else:
        lse = fused_ce.fused_lse_fwd(x, w, planes=planes)
    torch.cuda.synchronize()
    _close(lse, want_lse.float())


@pytest.mark.parametrize("d", [1, 16, 33, 64, 65, 100, 128, 129, 200, 256])
def test_linear_ce_forward_covers_every_launch_plan(dev, d):
    """Depths whose forward plans differ (64- or 32-row streamed tiles, one
    to eight warps, two or three ring stages), with cap 30 and without,
    positions that leave the last row block short, and a catalog whose last
    tile has 5 columns: with 300 positions its split holds that tile alone,
    so lanes whose columns are all masked start there from nothing. Loss
    and lse within ``1e-5·max|want|`` of the f64 plain version."""
    n, c = 300, 64 * 60 + 5
    x, w, t, _ = _ce_problem(dev, 86 + d, n, c, d)
    x = x / 3.0
    t[: n // 2] = c - 1
    for cap in (None, 30.0):
        loss, lse = linear_sce.linear_ce_fwd(x, w, t, logit_softcap=cap)
        plain_lse = fused_ce.fused_lse_fwd(x, w) if cap is None else None
        torch.cuda.synchronize()
        xd, wd = x.double(), w.double()
        want_lse = ref.fused_lse_ref(xd, wd, logit_softcap=cap).float()
        _close(lse, want_lse)
        _close(loss, ref.linear_ce_loss_ref(xd, wd, t,
                                            logit_softcap=cap).float())
        if plain_lse is not None:
            _close(plain_lse, want_lse)


def test_linear_ce_forward_plan_equals_the_library(dev):
    """The guard's preflight trusts ``linear_sce.fwd_plan``, the wrapper's
    copy of the forward's launch plan: it equals the library's at every
    depth, and fits a block's shared memory."""
    for d in range(1, linear_sce.MAX_D + 1):
        plan = linear_sce.library_fwd_plan(d)
        assert linear_sce.fwd_plan(d) == plan, d
        assert plan[0] >= 1 and plan[2] <= linear_sce.MAX_SMEM
    with pytest.raises(ValueError):
        linear_sce.library_fwd_plan(linear_sce.MAX_D + 1)


def test_linear_ce_backward_plan_equals_the_library(dev):
    """The guard's preflight trusts ``linear_sce.bwd_plan``, the wrapper's
    copy of the kernel's launch plan: it equals the library's at every
    depth, and fits a block's shared memory."""
    for d in range(1, linear_sce.MAX_D + 1):
        for dw in (False, True):
            plan = linear_sce.library_bwd_plan(d, dw)
            assert linear_sce.bwd_plan(d, dw) == plan, (d, dw)
            assert plan[2] <= linear_sce.MAX_SMEM
    with pytest.raises(ValueError):
        linear_sce.library_bwd_plan(linear_sce.MAX_D + 1, False)


@pytest.mark.parametrize("pluck", [True, False])
def test_linear_ce_caps_the_exp_of_an_lse_far_below_the_logits(dev, pluck):
    """The kernels' one deviation from the plain version: the cotangent's
    exp takes ``min(l - lse, 44)``. With the lse of the same logits
    ``l - lse <= 0`` and the cap never acts; here the lse lies 60 below
    it, so the plain version's gradient is orders of magnitude larger than
    the kernels' (and would reach inf further down), while the kernels hold
    the plain formula with the capped exponent, evaluated in f64, at the
    usual tolerance."""
    x, w, t, gr = _ce_problem(dev, 84, 70, 1_037, 64)
    tt = t if pluck else None
    lse = ref.fused_lse_ref(x, w) - 60.0
    dx = linear_sce.linear_ce_dx(x, w, tt, lse, gr)
    dw = linear_sce.linear_ce_dw(x, w, tt, lse, gr)
    torch.cuda.synchronize()
    xd, wd = x.double(), w.double()
    z = xd @ wd.T - lse.double()[:, None]
    assert (z > 50.0).any()
    p = torch.exp(z.clamp(max=44.0))
    if pluck:
        p[torch.arange(len(t), device=dev), t.long()] -= 1.0
    gw = p * gr.double()[:, None]
    _close(dx, (gw @ wd).float(), rtol=2e-4)
    _close(dw, (gw.T @ xd).float(), rtol=2e-4)
    plain = ref.linear_ce_dx_ref(x, w, tt, lse, gr)
    assert plain.abs().max() > 1e4 * dx.abs().max()


def test_linear_ce_raises_on_what_it_does_not_take(dev):
    x, w, t, gr = _ce_problem(dev, 7, 16, 100, 8)
    for fn in (lambda *a: ops.linear_ce_loss(*a),
               lambda *a: ops.fused_ce_loss(*a),
               lambda x_, w_, t_: ops.fused_lse(x_, w_)):
        with pytest.raises(ValueError, match="CPU or a CUDA device"):
            fn(x, w.cpu(), t)
        with pytest.raises(ValueError, match="CPU or a CUDA device"):
            fn(x.cpu(), w, t.cpu())
    with pytest.raises(TypeError):
        linear_sce.linear_ce_fwd(x, w, t.long())
    with pytest.raises(TypeError):
        linear_sce.linear_ce_fwd(x.double(), w.double(), t)
    with pytest.raises(ValueError):
        linear_sce.linear_ce_fwd(x, torch.zeros(8, 100, device=dev).T, t)
    with pytest.raises(ValueError):
        linear_sce.linear_ce_fwd(torch.zeros(16, 300, device=dev),
                                 torch.zeros(100, 300, device=dev), t)
    with pytest.raises(ValueError):
        linear_sce.linear_ce_fwd(x, w, t, logit_softcap=-1.0)


# ---------------------------------------------------------------------------
# The kernel guard on the card
# ---------------------------------------------------------------------------
def test_every_conformance_canary_passes_on_the_card(dev):
    verdicts = guard.run_conformance(device=dev, refresh=True)
    assert sorted(verdicts) == sorted(guard.KNOWN_KERNELS)
    for v in verdicts.values():
        assert v.passed, v.failures
    assert sum(v.n_pass for v in verdicts.values()) == 12
    bucket = dict(verdicts["sce_bucket"].launches)
    assert bucket == {"sce_bucket_fwd": 3, "sce_bucket_dx": 1,
                      "sce_bucket_dy": 1, "sce_bucket_plse_fwd": 1}
    two_pass = dict(verdicts["eval_topk"].launches)
    assert two_pass == {"eval_topk": 1, "eval_tgt_scores": 1}


def test_broken_kernel_raises_under_warn(dev, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("injected miscompile")

    monkeypatch.setattr(kernel, "mips_topk", broken)
    guard.clear_verdicts("mips_topk")
    guard.set_policy("warn")
    try:
        q = torch.randn(6, 8, device=dev)
        y = torch.randn(10, 8, device=dev)
        with pytest.raises(guard.KernelConformanceError) as ei:
            ops.mips_topk(q, y, 4)
        assert ei.value.kernel == "mips_topk"
        assert any("injected miscompile" in f for f in ei.value.failures)
    finally:
        guard.set_policy(None)
        monkeypatch.undo()
        guard.clear_verdicts("mips_topk")


def test_preflight_refuses_what_the_kernels_do_not_take(dev):
    q = torch.zeros(4, 300, device=dev)
    with pytest.raises(guard.KernelPreflightError) as ei:
        ops.mips_topk(q, torch.zeros(20, 300, device=dev), 3)
    assert ei.value.rule == "d_max"
    with pytest.raises(guard.KernelPreflightError) as ei:
        ops.eval_fused(torch.zeros(4, 8, device=dev),
                       torch.zeros(700, 8, device=dev),
                       torch.zeros(4, dtype=torch.int32, device=dev), 600)
    assert ei.value.rule == "k_max"


# ---------------------------------------------------------------------------
# sce_bucket: forward, dX, dY over pre-gathered candidates
# ---------------------------------------------------------------------------
def _bucket_launches():
    return tuple(f.launches for f in (
        sce_bucket.sce_bucket_fwd, sce_bucket.sce_bucket_dx,
        sce_bucket.sce_bucket_dy))


@pytest.mark.parametrize("shape,cap", [
    ((2, 16, 24, 8, 100), None),
    ((3, 100, 50, 16, 257), None),  # ragged everything
    ((5, 23, 50, 33, 300), 30.0),  # d % 4 != 0, softcap
    ((3, 64, 48, 256, 500), 30.0),  # d at the kernel's cap
    ((320, 320, 256, 64, 173_520), None),  # the training shape
])
def test_sce_bucket_kernels_match_plain(dev, shape, cap):
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, sum(shape) + 2,
                                                  *shape)
    y_b = y[idx.long()]
    if cap is not None:
        x_b = x_b * 8.0
        pos = cap * torch.tanh(pos * 20.0 / cap)
    g = torch.rand(pos.shape, generator=_gen(dev, 12), device=dev)
    before = _bucket_launches()
    leaves = [t.clone().requires_grad_(True) for t in (x_b, y_b, pos)]
    loss = ops.sce_bucket_loss(leaves[0], leaves[1], tgt, cand, leaves[2],
                               logit_softcap=cap)
    got = torch.autograd.grad((loss * g).sum(), leaves)
    torch.cuda.synchronize()
    assert _bucket_launches() == tuple(n + 1 for n in before)
    plain = [t.clone().requires_grad_(True) for t in (x_b, y_b, pos)]
    want_loss = ref.sce_bucket_loss_ref(plain[0], plain[1], tgt, cand,
                                        plain[2], cap)
    want = torch.autograd.grad((want_loss * g).sum(), plain)
    _close(loss.detach(), want_loss.detach())
    for a, b in zip(got, want):
        _close(a, b, rtol=2e-4)
    assert (got[1][cand < 0] == 0).all()  # masked slots: exact 0 rows

    # the partial LSE; its dX and dY are the loss's launches
    plse_before = (sce_bucket.sce_bucket_plse_fwd.launches,
                   sce_bucket.sce_bucket_dx.launches,
                   sce_bucket.sce_bucket_dy.launches)
    leaves = [t.clone().requires_grad_(True) for t in (x_b, y_b)]
    plse = ops.sce_bucket_plse(leaves[0], leaves[1], tgt, cand,
                               logit_softcap=cap)
    got = torch.autograd.grad((plse * g).sum(), leaves)
    plain = [t.clone().requires_grad_(True) for t in (x_b, y_b)]
    want_plse = ref.sce_bucket_plse_ref(plain[0], plain[1], tgt, cand, cap)
    want = torch.autograd.grad((want_plse * g).sum(), plain)
    assert (sce_bucket.sce_bucket_plse_fwd.launches,
            sce_bucket.sce_bucket_dx.launches,
            sce_bucket.sce_bucket_dy.launches) == tuple(
                n + 1 for n in plse_before)
    _close(plse.detach(), want_plse.detach())
    for a, b in zip(got, want):
        _close(a, b, rtol=2e-4)


def test_sce_bucket_equals_sce_gather_and_dy_repeats(dev):
    """The direct walk is the gathered one on ``y_b = y[idx]``: forward
    and dX equal bit for bit; dY, written rather than added, repeats bit
    for bit."""
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 21, 40, 70, 90, 64,
                                                  5_000)
    y_b = y[idx.long()]
    a = sce_bucket.sce_bucket_fwd(x_b, y_b, tgt, cand, pos)
    b = sce_prefetch.sce_gather_fwd(x_b, y, idx, tgt, cand, pos)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    g = torch.rand(pos.shape, generator=_gen(dev, 22), device=dev)
    assert torch.equal(
        sce_bucket.sce_bucket_dx(x_b, y_b, tgt, cand, a[1], g),
        sce_prefetch.sce_gather_dx(x_b, y, idx, tgt, cand, a[1], g))
    d1 = sce_bucket.sce_bucket_dy(x_b, y_b, tgt, cand, a[1], g)
    d2 = sce_bucket.sce_bucket_dy(x_b, y_b, tgt, cand, a[1], g)
    assert torch.equal(d1, d2)
    assert (d1[cand < 0] == 0).all()


def test_sce_bucket_raises_on_what_it_does_not_take(dev):
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 4, 2, 16, 24, 8, 100)
    y_b = y[idx.long()]
    with pytest.raises(TypeError):
        sce_bucket.sce_bucket_fwd(x_b, y_b, tgt.long(), cand, pos)
    with pytest.raises(ValueError):
        sce_bucket.sce_bucket_fwd(x_b, y_b[:1], tgt, cand, pos)
    with pytest.raises(ValueError):
        sce_bucket.sce_bucket_fwd(x_b, y_b.cpu(), tgt, cand, pos)
    with pytest.raises(ValueError):
        sce_bucket.sce_bucket_fwd(x_b, y_b.transpose(0, 1), tgt,
                                  cand.T.contiguous(), pos)


# ---------------------------------------------------------------------------
# eval_topk, eval_tgt_scores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,c,d,k,integer,c_lo,c_hi,id_offset", [
    (128, 20_000, 64, 10, True, 1, 19_990, 0),
    (256, 30_000, 64, 10, False, 1, 29_990, 0),
    (40, 1_037, 33, 17, True, 1_003, 1_900, 1_000),  # ragged, offset
    (9, 500, 64, 12, True, 3, 9, 0),  # k > valid columns
    (33, 3_000, 64, 300, False, 0, 3_000, 0),  # 16 slots
])
def test_eval_topk_kernels_match_plain(dev, n, c, d, k, integer, c_lo, c_hi,
                                       id_offset):
    x, y, t = _eval_problem(dev, n + c + 1, n, c, d, integer, id_offset,
                            c_lo, c_hi)
    before = (topk_kernel.eval_topk.launches,
              topk_kernel.eval_tgt_scores.launches)
    with pytest.warns(DeprecationWarning):
        ts = ops.eval_tgt_scores(x, y, t, id_offset=id_offset)
    with pytest.warns(DeprecationWarning):
        vals, ids, gt, eq = ops.eval_topk(x, y, ts, k, c_lo=c_lo, c_hi=c_hi,
                                          id_offset=id_offset)
    torch.cuda.synchronize()
    assert (topk_kernel.eval_topk.launches,
            topk_kernel.eval_tgt_scores.launches) == tuple(
                b + 1 for b in before)
    ts_want = ref.eval_tgt_scores_ref(x, y, t, id_offset=id_offset)
    want = ref.eval_topk_ref(x, y, ts_want, k, c_lo=c_lo, c_hi=c_hi,
                             id_offset=id_offset)
    scores = x.double() @ y.double().T
    scale = scores.abs().max().item()
    _assert_match((vals, ids), want[:2], scale, integer)
    if integer:
        assert torch.equal(ts, ts_want)
        assert torch.equal(gt, want[2]) and torch.equal(eq, want[3])
    else:
        assert (ts - ts_want).abs().max().item() <= 1e-5 * scale
        gid = id_offset + torch.arange(c, device=dev)
        ok = (gid >= c_lo) & (gid < c_hi)
        tol = 1e-5 * scale
        s64 = ts.double()[:, None]
        lo = ((scores > s64 + tol) & ok[None, :]).sum(1)
        hi = ((scores >= s64 - tol) & ok[None, :]).sum(1)
        assert ((gt >= lo) & (gt + eq <= hi)).all()
    # eval_tgt_scores is bit for bit the column eval_topk sweeps
    valid_t = (t >= max(c_lo, id_offset)) & (t < min(c_hi, id_offset + c))
    assert (eq[valid_t] >= 1).all()
    hit = ids == t[:, None]
    assert torch.equal(vals[hit], ts[:, None].expand(-1, k)[hit])
    assert (ts[(t < id_offset) | (t >= id_offset + c)] == 0).all()


def test_eval_topk_kernels_are_deterministic(dev):
    x, y, t = _eval_problem(dev, 6, 64, 20_000, 64, False, 0, 1, 19_990)
    ts = topk_kernel.eval_tgt_scores(x, y, t)
    assert torch.equal(ts, topk_kernel.eval_tgt_scores(x, y, t))
    a = topk_kernel.eval_topk(x, y, ts, 10, c_lo=1, c_hi=19_990)
    b = topk_kernel.eval_topk(x, y, ts, 10, c_lo=1, c_hi=19_990)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_topk_kernels_order_nan_scores_as_the_plain_version(dev):
    """A NaN score (a diverged model) ranks above every number, NaNs among
    themselves by id — the plain version's order (and ``lax.top_k``'s) —
    in ``mips_topk``, ``eval_fused`` and ``eval_topk`` alike: the same ids,
    the NaN values reading +inf in the kernels' lists."""
    g = _gen(dev, 31)
    q = _ints(g, dev, 6, 64)
    y = _ints(g, dev, 900, 64)
    q[1] = float("nan")  # a whole row of NaN scores
    y[[5, 400, 777]] = float("nan")  # NaN columns for every row
    for k in (10, 64):  # the split sweep, the select chain
        got = kernel.mips_topk(q, y, k)
        want = ref.mips_topk_ref(q, y, k)
        assert torch.equal(got[1], want[1])
        nan = want[0].isnan()
        assert nan.any() and torch.equal(got[0] == float("inf"), nan)
        assert torch.equal(got[0][~nan], want[0][~nan])
        assert (got[1][1] == torch.arange(k, device=dev)).all()
    t = torch.arange(6, dtype=torch.int32, device=dev)
    fused = ops.eval_fused(q, y, t, 10)
    plain = ref.eval_fused_ref(q, y, t, 10)
    assert torch.equal(fused[1], plain[1])
    ts = topk_kernel.eval_tgt_scores(q, y, t)
    two = topk_kernel.eval_topk(q, y, ts, 10)
    assert torch.equal(two[1], ref.eval_topk_ref(q, y, ts, 10)[1])
