"""The hand-written CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and
skip without one. This file imports neither JAX nor the JAX package, so
it also runs where only PyTorch is installed; on such a machine run it
without the repository's JAX-importing ``conftest.py``::

    python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

``mips_topk``: integer-valued inputs make every f32 fold order exact (and
are their own TF32 ``hi`` in the k ≤ 32 sweep's 3xTF32), so the kernel
and the plain version must agree bit for bit (values, ids, tie order,
``ID_PAD`` tails); generic floats agree within ``1e-5·max|score|`` with
ids equal wherever neighbouring scores are further apart than that. The
tensor-core sweep (k ≤ 32; ``eval_fused`` / ``eval_topk`` at every k)
also at full width (C = 173,520, d = 64: n_q 8 / 32 / 512, B 128 / 256),
repeating bit for bit although its split lists depend on when each block
reads the shared threshold, with d % 8 ≠ 0 with and without a pre-pass,
and with the target's score bit for bit the swept column at B 256.
Above k = 32 (the threshold, collect and select chain) the same on its
adversarial inputs — the best columns in one residue of the threshold
pass's tiles, all-equal scores, fewer valid columns than k, k = C,
k = 512 — and with a collect buffer small enough that a row overflows
into the split sweep; two launches repeat bit for bit.

``sce_gather`` (forward, dX, dY): losses within ``1e-5·max|loss|``,
gradients within ``rtol 2e-4``, ``atol 1e-5·max|grad|`` of autograd
through the plain version (f32 sums in another order), and rows of dY
that no bucket selected exactly 0. All three take their logits in 3xTF32
on the tensor cores with one arithmetic: at the trainer's logit scale
(x_b 3·randn) they hold the plain version evaluated in f64 at the same
tolerances; given their forward's lse dX and dY are no farther from
their formula in f64 than the f32 plain formula is; end to end, dX is no
farther from f64 than twice the f32 plain version's error. A loss bucket
whose candidates are all masked has loss and dX exactly 0 and adds
nothing to dY; the wrappers' copies of the launch plans equal the
library's, and the forward launches at every depth of its plan (one
chunk of resident candidates or several, one row tile or two). The
gathered dY (a workspace row per slot, summed in slot order) and the
forwards repeat bit for bit, and the gathered dY is the in-order sum of
``sce_bucket``'s per-slot rows. Given an lse 60 below the logits, where
dX and dY cap exp's argument at 44, every SCE family holds the capped
formula.

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

The deep variants' product (``csrc/deep_tc.cuh``, behind every deep
entry: the score slabs, SCE and the full CE): in each of its 16 operand options (A M-major, B
N-major, B gathered by a clamped id, the accumulate epilogue; zeroed rows
with A M-major) at ragged shapes, K = 37 among them, within
``1e-5·max|C| + 2e-4·|C|`` of the plain version in f64, and a second
launch bit for bit the first. The deep full CE (``linear_ce_loss`` with
and without cap 30, ``fused_lse``, ``fused_ce_loss``) at d 288 and 2304 in
several catalog chunks, a target in the last and targets outside
``[0, C)``: forward, dX and dW/dY against the plain versions in f64 at
the d ≤ 256 tolerances, one launch of each counter; its entries repeat
bit for bit and the one-launch backward equals dX and dW alone.

``sce_bucket`` (forward, dX, dY over pre-gathered candidates, and the
partial LSE): the tolerances of ``sce_gather``; its forward and dX equal
``sce_gather``'s bit for bit on ``y_b = y[idx]`` (the same tile walk),
and its dY — written, not added — repeats bit for bit.

The deep sweep that reads the score slab (``topk_tile.cuh`` ``FROM_S``:
a ring of TMA boxes) at d 300 on f32 and bf16 operands, C not a
multiple of 64 and below one tile, n not a multiple of the block, a
window that cuts tiles, one slab and several: ``eval_fused``,
``eval_topk`` and the deep ``mips_topk`` (k ≤ 32, a mask) equal PyTorch
on the kernels' own slab (``eval_fused.score_slab``) bit for bit — values,
ids, ``gt``, ``eq``, the target score —, ``(m, s)`` lie within f64
tolerance of it, and a second launch repeats every output.

``eval_topk`` / ``eval_tgt_scores``: as ``eval_fused``, without the
self-column rule; ``eval_tgt_scores`` is bit for bit the column
``eval_topk`` sweeps (``eq >= 1`` on every row whose target is valid).

The kernel guard: every conformance canary passes on the card, and a
broken kernel raises ``KernelConformanceError`` under ``warn``.

bfloat16 operands (every family, resident and deep): ``mips_topk``
(k ≤ 32, the k > 32 chain, deep slabs at gemma-2's d 2304 and k 1024),
``eval_fused`` / ``eval_tgt_gather`` / ``eval_topk`` / ``eval_tgt_scores``,
the SCE and partial-LSE forwards (gathered and direct) and the full-CE
forwards on bf16 inputs equal the f32 kernels on the widened inputs bit
for bit and repeat; the backwards (SCE loss, partial LSE, ``sce_bucket``,
``linear_ce_loss``, ``fused_lse``) come out in the operands' type within
``3e-2`` of the largest value of the plain versions, which round the
cotangent to bf16 as the kernels do, and repeat bit for bit;
``deep_tc.cuh``'s one TF32 pass on bf16 operands equals its three passes
on the widened ones in every orientation the slabs and gradients use; a
bf16 / f32 mix, float16 and float64 raise ``TypeError``.

BERT4Rec and the seqrec serve steps (at the smoke config and at d 64,
2 blocks over a 20,000-item catalog): one SCE train step on the card's
kernels (the cloze mask and Ω injected, ``mips_topk`` launched twice)
against the same step on the CPU's plain versions — loss and grad norm
within ``1e-5`` relative, params within ``1e-5·max|p|`` but for under
1 % of elements, which Adam may move by a full ±lr step each way from a
near-zero gradient (``2·lr``) —; the MIPS serve step, the top-100 serve
step and the retrieval step against the same steps on the CPU, values
within ``1e-5·max|score|``, ids or positions equal where isolated, tied
copies lower id first.

The sharded paths' local stages (a 4-way model split, each shard's
stage run in turn on the card, as ``chip_smoke.py``'s distribution phase
runs them at full width): the shards' ``eval_tgt_gather`` at their
``id_offset`` summed, each shard's ``eval_fused`` against that target
score, merged by ``dist.collectives.merge_gathered_topk`` /
``merge_gathered_lse`` and the summed counts, equal the unsharded
``eval_fused`` bit for bit (values, ids, ``gt``, ``eq``, the target
score; f32 and bf16, rows tied across shards, phantom rows in the last
shard), the LSE within ``1e-5`` relative; the serve steps'
``mips_topk`` stage likewise, bit for bit.

Checkpoints: a train state restored onto ``cuda`` keeps the CUDA
generator's state, so the next Mix Ω draw (``make_bucket_centers``)
equals the uninterrupted generator's bit for bit, and its params and
AdamW state come back on the card bit for bit. The
``dev`` fixture runs the canaries once before any test counts launches,
so a test's launch counts hold its own launches only.
"""
import itertools
import math

import pytest
import torch

from repro_torch.kernels import eval_fused as eval_kernel
from repro_torch.kernels import eval_topk as topk_kernel
from repro_torch.kernels import deep, fused_ce, guard, linear_sce
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
    # The deep variants: d > 256 (the score slab, then the same sweep or
    # chain) and 512 < k ≤ 1024 at any d; gemma-2's d 2304.
    (8, 5_000, 300, 10, True, "window", 0),
    (33, 3_000, 2_304, 10, False, None, 0),
    (40, 3_000, 300, 320, True, "random", 0),
    (20, 4_000, 2_304, 128, False, "random", 3),
    (16, 3_000, 64, 1_024, True, "window", 0),
    (12, 5_000, 2_304, 1_024, False, "random", 0),
    (9, 500, 300, 320, True, "starved", 1_000),
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
    with pytest.raises(ValueError):  # k > 1024
        kernel.mips_topk(q, torch.zeros(1_100, 8, device=dev), 1_025)
    with pytest.raises(ValueError):  # a collect buffer below k
        kernel.mips_topk(q, torch.zeros(700, 8, device=dev), 40, kcap=39)
    with pytest.raises(ValueError):  # d = 0
        kernel.mips_topk(torch.zeros(4, 0, device=dev),
                         torch.zeros(20, 0, device=dev), 3)
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
    # the deep variant: the logits written once, then folded / multiplied
    ((3, 40, 70, 300, 500), None, False),
    ((2, 33, 100, 2_304, 400), 30.0, False),  # gemma-2's d and final cap
    ((2, 16, 24, 2_304, 50), None, True),
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
    # Above d 256 logits of |x_b·y| ~ 3·sqrt(d) make the f32 plain
    # version's own rounding the larger error: hold the deep variant to
    # the plain version in f64.
    dt = torch.float64 if shape[3] > 256 else torch.float32
    plain = [t.to(dt).clone().requires_grad_(True) for t in (x_b, y, pos)]
    want_loss = ref.sce_gather_loss_ref(plain[0], plain[1], idx, tgt, cand,
                                        plain[2], cap)
    want = torch.autograd.grad((want_loss * g.to(dt)).sum(), plain)
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
    with pytest.raises(ValueError):  # x_b and y of different depths
        big = torch.zeros(2, 16, 300, device=dev)
        sce_prefetch.sce_gather_fwd(big, torch.zeros(100, 8, device=dev),
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


@pytest.mark.parametrize("plse", [False, True])
def test_sce_gather_end_to_end_at_the_trainer_logit_scale(dev, plse):
    """x_b at 3·randn, through ``ops``: the forward's lse comes from the
    logits the backward recomputes, so end to end the loss (plse), dX and
    dY hold autograd through the plain version in f64 at the chip
    tolerance, and dX is no farther from it than twice the f32 plain
    version's error on the same inputs."""
    shape = (16, 320, 256, 64, 20_000)
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 41, *shape)
    x_b = 3.0 * x_b
    pos = (x_b * y[tgt.long()]).sum(-1)
    if plse:
        cand = torch.where(torch.rand(cand.shape, generator=_gen(dev, 42),
                                      device=dev) < 0.5, cand, -1)
    up = torch.rand(shape[:2], generator=_gen(dev, 43), device=dev)

    def run(fn, dtype):
        leaves = [t.to(dtype).requires_grad_(True) for t in (x_b, y)]
        rest = () if plse else (pos.to(dtype),)
        out = fn(leaves[0], leaves[1], idx, tgt, cand, *rest)
        return [out.detach()] + list(
            torch.autograd.grad((out * up.to(dtype)).sum(), leaves))

    kernel = ops.sce_gather_plse if plse else ops.sce_gather_loss
    plain = ref.sce_gather_plse_ref if plse else ref.sce_gather_loss_ref
    got = run(kernel, torch.float32)
    f32 = run(plain, torch.float32)
    exact = run(plain, torch.float64)
    live = exact[0] > -1e29
    _close(got[0][live], exact[0][live].float())
    for a, b in zip(got[1:], exact[1:]):
        _close(a, b.float(), rtol=2e-4)
    assert _max_err(got[1], exact[1]) <= 2 * _max_err(f32[1], exact[1]), (
        _max_err(got[1], exact[1]), _max_err(f32[1], exact[1]))


def _cap_problem(dev, family):
    """Inputs of one SCE family for the exp-cap test: the loss's or the
    partial LSE's (a third of the candidates masked), gathered or over
    pre-gathered rows."""
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 44, 6, 70, 90, 64,
                                                  1_000)
    if family.endswith("plse"):
        cand[:, 1::3] = -1
    return x_b, y, idx, tgt, cand, pos


@pytest.mark.parametrize("family", ["gather", "gather_plse", "bucket",
                                    "bucket_plse"])
def test_sce_backward_caps_the_exp_of_an_lse_far_below_the_logits(dev,
                                                                  family):
    """The SCE backward's one deviation from the plain version: dX and dY
    take ``exp(min(l − lse, 44))``. Given an lse 60 below the forward's,
    the plain formula's entries grow orders of magnitude past the
    kernels', while every family's dX and dY (the loss's and the partial
    LSE's, gathered and direct) hold the formula with the capped exponent
    evaluated in f64, at the usual tolerance."""
    x_b, y, idx, tgt, cand, pos = _cap_problem(dev, family)
    y_b = y[idx.long()].contiguous()
    gr = torch.rand(pos.shape, generator=_gen(dev, 45), device=dev)
    plse = family.endswith("plse")
    base = (ref.sce_gather_plse_ref(x_b, y, idx, tgt, cand) if plse
            else ref.sce_gather_loss_ref(x_b, y, idx, tgt, cand, pos) + pos)
    lse = base - 60.0
    if family == "gather":
        args = (x_b, y, idx, tgt, cand, lse, gr)
        dx, dy = sce_prefetch.sce_gather_dx(*args), \
            sce_prefetch.sce_gather_dy(*args)
    elif family == "gather_plse":
        args = (x_b, y, idx, tgt, cand, lse, gr)
        dx, dy = sce_prefetch.sce_gather_plse_dx(*args), \
            sce_prefetch.sce_gather_plse_dy(*args)
    else:
        args = (x_b, y_b, tgt, cand, lse, gr)
        dx, dy = sce_bucket.sce_bucket_dx(*args), \
            sce_bucket.sce_bucket_dy(*args)
    torch.cuda.synchronize()
    xd, ybd = x_b.double(), y_b.double()
    z = torch.einsum("nxd,nyd->nxy", xd, ybd) - lse.double()[..., None]
    masked = (cand[:, None, :] < 0) | (cand[:, None, :] == tgt[:, :, None])
    assert (z[~masked] > 50.0).any()
    gw = torch.where(masked, 0.0, torch.exp(z.clamp(max=44.0))
                     * gr.double()[..., None])
    want_dy_b = torch.bmm(gw.transpose(1, 2), xd)
    _close(dx, torch.bmm(gw, ybd).float(), rtol=2e-4)
    if family.startswith("bucket"):
        _close(dy, want_dy_b.float(), rtol=2e-4)
    else:
        want_dy = torch.zeros(y.shape, dtype=torch.float64, device=dev)
        want_dy.index_add_(0, idx.long().reshape(-1),
                           want_dy_b.reshape(-1, y.shape[1]))
        _close(dy, want_dy.float(), rtol=2e-4)
    plain_dx, _ = _gather_grads_given_lse(x_b, y, idx, tgt, cand, lse, gr)
    assert plain_dx.abs().max() > 100 * dx.abs().max()


@pytest.mark.parametrize("d", [1, 16, 33, 64, 65, 100, 128, 129, 200, 256])
def test_sce_gather_forward_covers_every_launch_plan(dev, d):
    """Depths whose forward plans differ (ten warps down to two, 256 or 64
    resident candidates), with b_x = 330 (a second row tile) and b_y = 300
    (two chunks or more), cap 30 and none: the plan equals the library's,
    and the loss, lse and plse (gathered and direct) hold the f64 plain
    version within ``1e-5·max|want|``."""
    plan = sce_prefetch.library_fwd_plan(d)
    assert sce_prefetch.fwd_plan(d) == plan
    warps, smem, rows = plan
    assert smem <= sce_prefetch.MAX_SMEM and rows < 300  # two chunks or more
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 46 + d, 3, 330, 300,
                                                  d, 2_000)
    x_b = x_b / max(1.0, d ** 0.5 / 4)
    y_b = y[idx.long()].contiguous()
    for cap in (None, 30.0):
        loss, lse = sce_prefetch.sce_gather_fwd(x_b, y, idx, tgt, cand, pos,
                                                logit_softcap=cap)
        plse = sce_prefetch.sce_gather_plse_fwd(x_b, y, idx, tgt, cand,
                                                logit_softcap=cap)
        b_loss, b_lse = sce_bucket.sce_bucket_fwd(x_b, y_b, tgt, cand, pos,
                                                  logit_softcap=cap)
        b_plse = sce_bucket.sce_bucket_plse_fwd(x_b, y_b, tgt, cand,
                                                logit_softcap=cap)
        torch.cuda.synchronize()
        xd, yd, pd = x_b.double(), y.double(), pos.double()
        want = ref.sce_gather_loss_ref(xd, yd, idx, tgt, cand, pd, cap)
        want_p = ref.sce_gather_plse_ref(xd, yd, idx, tgt, cand, cap)
        for a, b in ((loss, want), (lse, want + pd), (plse, want_p)):
            _close(a, b.float())
        assert torch.equal(b_loss, loss) and torch.equal(b_lse, lse)
        assert torch.equal(b_plse, plse)


def test_sce_gather_dy_and_forwards_repeat_bit_for_bit(dev):
    """No atomics: two calls of the gathered dY (loss and partial LSE) are
    equal bit for bit, with rows no bucket selected exactly 0, on
    candidates that every bucket shares (each catalog row summed over 40
    buckets); so are two calls of each forward. The gathered dY is the
    in-order sum of ``sce_bucket``'s per-slot rows on ``y_b = y[idx]``."""
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 47, 40, 70, 90, 64,
                                                  5_000, same=True)
    cand[:, ::7] = -1
    g = torch.rand(pos.shape, generator=_gen(dev, 48), device=dev)
    args = (x_b, y, idx, tgt, cand)
    f1 = sce_prefetch.sce_gather_fwd(*args, pos)
    f2 = sce_prefetch.sce_gather_fwd(*args, pos)
    assert torch.equal(f1[0], f2[0]) and torch.equal(f1[1], f2[1])
    p1 = sce_prefetch.sce_gather_plse_fwd(*args)
    assert torch.equal(p1, sce_prefetch.sce_gather_plse_fwd(*args))
    before = sce_prefetch.sce_gather_dy_sum.launches
    d1 = sce_prefetch.sce_gather_dy(*args, f1[1], g)
    d2 = sce_prefetch.sce_gather_dy(*args, f1[1], g)
    assert sce_prefetch.sce_gather_dy_sum.launches == before + 2
    assert torch.equal(d1, d2)
    touched = torch.zeros(y.shape[0], dtype=torch.bool, device=dev)
    touched[idx.long().reshape(-1)] = True
    assert (d1[~touched] == 0).all() and (d1[touched] != 0).any()
    assert torch.equal(sce_prefetch.sce_gather_plse_dy(*args, p1, g),
                       sce_prefetch.sce_gather_plse_dy(*args, p1, g))
    y_b = y[idx.long()].contiguous()
    dy_b = sce_bucket.sce_bucket_dy(x_b, y_b, tgt, cand, f1[1], g)
    keys, order = sce_prefetch.dy_sum_keys(idx, cand, y.shape[0])
    summed = sce_prefetch.sce_gather_dy_sum(dy_b.reshape(-1, y.shape[1]),
                                            keys, order, torch.zeros_like(y))
    assert torch.equal(summed, d1)
    _close(summed, sce_prefetch.dy_sum_plain(dy_b.reshape(-1, y.shape[1]),
                                             idx, cand, y.shape[0]),
           rtol=2e-4)


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
    ((3, 40, 70, 300, 500), 30.0, 0.5),  # the deep variant
    ((2, 33, 100, 2_304, 400), None, 0.25),
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
    dt = torch.float64 if shape[3] > 256 else torch.float32  # as above
    plain = [t.to(dt).clone().requires_grad_(True) for t in (x_b, y)]
    want_plse = ref.sce_gather_plse_ref(plain[0], plain[1], idx, tgt, cand,
                                        cap)
    want = torch.autograd.grad((want_plse * up.to(dt)).sum(), plain)
    plse = plse.detach()
    assert torch.isfinite(plse).all()
    assert (plse[0] == -1e30).all() and (got[0][0] == 0).all()
    live = want_plse.detach() > -1e29
    assert torch.equal(plse[~live], want_plse.detach()[~live].float())
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
    # the deep variant (the score slab, then the same sweep)
    (40, 3_000, 300, 10, True, True, 30.0, 1, 2_990, 0),
    (64, 5_000, 2_304, 1, False, True, 30.0, 1, 4_990, 0),  # token rank
    (33, 2_000, 2_304, 40, True, False, None, 3, 1_900, 0),
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
    with pytest.raises(TypeError):  # f64 (f32 or bf16 operands only)
        eval_kernel.eval_fused(x.double(), y.double(), t, 3)
    with pytest.raises(TypeError):  # a bf16 / f32 mix
        eval_kernel.eval_fused(x.bfloat16(), y, t, 3)
    with pytest.raises(ValueError):
        eval_kernel.eval_fused(x, y, t.long(), 3)
    with pytest.raises(ValueError):
        eval_kernel.eval_fused(x, torch.zeros(8, 700, device=dev).T, t, 3)
    with pytest.raises(ValueError):
        eval_kernel.eval_fused(x, y, t, 600)  # k > 512
    with pytest.raises(ValueError):  # x and y of different depths
        eval_kernel.eval_fused(torch.zeros(4, 300, device=dev),
                               torch.zeros(20, 8, device=dev), t, 3)
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
    C + 3, inside the plain version's last chunk's padding) pluck 0 on
    both, the contract of ``ops.linear_ce_loss``: the kernel's loss is
    exactly its lse there, and within the tolerance of the plain
    version's on every row."""
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
        _close(loss, want.float())
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
    with pytest.raises(ValueError):  # targets of another length, deep
        linear_sce.linear_ce_fwd(torch.zeros(16, 300, device=dev),
                                 torch.zeros(100, 300, device=dev), t[:-1])
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
    # d 300 is planned (the deep variant's product), not refused
    loss = ops.linear_ce_loss(q, torch.zeros(20, 300, device=dev),
                              torch.zeros(4, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert torch.allclose(loss, torch.full((4,), math.log(20.0),
                                           device=dev))
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
    ((3, 40, 70, 300, 500), 30.0),  # the deep variant
    ((2, 33, 100, 2_304, 400), None),
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
    dt = torch.float64 if shape[3] > 256 else torch.float32  # as above
    plain = [t.to(dt).clone().requires_grad_(True) for t in (x_b, y_b, pos)]
    want_loss = ref.sce_bucket_loss_ref(plain[0], plain[1], tgt, cand,
                                        plain[2], cap)
    want = torch.autograd.grad((want_loss * g.to(dt)).sum(), plain)
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
    plain = [t.to(dt).clone().requires_grad_(True) for t in (x_b, y_b)]
    want_plse = ref.sce_bucket_plse_ref(plain[0], plain[1], tgt, cand, cap)
    want = torch.autograd.grad((want_plse * g.to(dt)).sum(), plain)
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
    (40, 3_000, 2_304, 10, True, 1, 2_990, 0),  # the deep variant
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


# ---------------------------------------------------------------------------
# The tensor-core sweep (mips_topk at k ≤ 32, eval_fused, eval_topk) at
# full width: C = 173,520 catalog rows, d = 64, k = 10
# ---------------------------------------------------------------------------
C_FULL = 173_520
N_ITEMS = 173_511


def _full_catalog(dev, seed):
    g = _gen(dev, seed)
    y = torch.randn(C_FULL, 64, generator=g, device=dev) * 0.02
    gid = torch.arange(C_FULL, device=dev)
    return g, y, (gid >= 1) & (gid < N_ITEMS)


@pytest.mark.parametrize("n_q", [8, 32, 512])
def test_sweep_at_full_width_matches_plain_mips_topk(dev, n_q):
    g, y, window = _full_catalog(dev, n_q)
    q = torch.randn(n_q, 64, generator=g, device=dev)
    before = kernel.mips_topk.launches_by_k[10]
    got = ops.mips_topk(q, y, 10, valid=window)
    torch.cuda.synchronize()
    assert kernel.mips_topk.launches_by_k[10] == before + 1
    want = ref.mips_topk_ref(q, y, 10, valid=window)
    _assert_match(got, want, (q @ y.T).abs().max().item(), False)
    assert ((got[1] >= 1) & (got[1] < N_ITEMS)).all()


@pytest.mark.parametrize("b", [128, 256])
def test_sweep_at_full_width_matches_plain_eval(dev, b):
    g, y, _ = _full_catalog(dev, b + 1)
    x = torch.randn(b, 64, generator=g, device=dev) * 3.0
    t = torch.randint(1, N_ITEMS, (b,), generator=g, device=dev,
                      dtype=torch.int32)
    kw = dict(c_lo=1, c_hi=N_ITEMS, with_lse=True)
    vals, ids, gt, eq, tgt, m, s = ops.eval_fused(x, y, t, 10, **kw)
    want = ref.eval_fused_ref(x, y, t, 10, **kw)
    scores = x.double() @ y.double().T
    scale = scores.abs().max().item()
    _assert_match((vals, ids), want[:2], scale, False)
    assert (tgt - want[4]).abs().max().item() <= 1e-5 * scale
    gid = torch.arange(C_FULL, device=dev)
    ok = (gid >= 1) & (gid < N_ITEMS)
    other = ok[None, :] & (gid[None, :] != t[:, None])
    t64 = scores.gather(1, t.long()[:, None])[:, 0]
    tol = 1e-5 * scale
    lo = ((scores > t64[:, None] + tol) & other).sum(1)
    hi = ((scores >= t64[:, None] - tol) & other).sum(1)
    rank = gt + (eq - 1).clamp_min(0)
    assert ((rank >= lo) & (rank <= hi)).all() and (eq >= 1).all()
    lse, want_lse = m + torch.log(s), want[5] + torch.log(want[6])
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=0)
    with pytest.warns(DeprecationWarning):
        two = ops.eval_topk(x, y, tgt, 10, c_lo=1, c_hi=N_ITEMS)
    assert torch.equal(two[0], vals) and torch.equal(two[1], ids)


def test_target_score_is_the_swept_column_bit_for_bit(dev):
    """On random floats at B 256: ``eval_tgt_scores`` against the full
    catalog gives ``eq >= 1`` in ``eval_topk`` (which has no self-column
    rule: only an equal swept score counts) on every row; and over a
    catalog of the 256 targets alone, swept at k 256, every row's own
    target column reads exactly its ``eval_tgt_gather`` score."""
    g, y, _ = _full_catalog(dev, 9)
    x = torch.randn(256, 64, generator=g, device=dev) * 3.0
    t = torch.randperm(N_ITEMS - 1, generator=g, device=dev)[:256] + 1
    t = t.to(torch.int32)
    ts = topk_kernel.eval_tgt_scores(x, y, t)
    _, _, gt, eq = topk_kernel.eval_topk(x, y, ts, 10, c_lo=1, c_hi=N_ITEMS)
    assert (eq >= 1).all()
    assert torch.equal(ts, eval_kernel.eval_tgt_gather(x, y, t))
    y_t = y[t.long()].contiguous()
    own = torch.arange(256, dtype=torch.int32, device=dev)
    tg = eval_kernel.eval_tgt_gather(x, y_t, own)
    vals, ids, _, eq_t, _, _, _ = eval_kernel.eval_fused(x, y_t, own, 256,
                                                         tgt_scores=tg)
    hit = ids == own[:, None]
    assert (hit.sum(1) == 1).all()
    assert torch.equal(vals[hit], tg)
    assert torch.equal(tg, ts)  # the same pair at another place in a tile


def test_sweep_repeats_bit_for_bit(dev):
    """The shared threshold makes the split lists depend on when each block
    reads τ; the outputs do not."""
    g, y, window = _full_catalog(dev, 12)
    for n_q in (8, 32, 512):
        q = torch.randn(n_q, 64, generator=g, device=dev)
        a = kernel.mips_topk(q, y, 10, valid=window)
        for _ in range(2):
            b = kernel.mips_topk(q, y, 10, valid=window)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    x = torch.randn(256, 64, generator=g, device=dev)
    t = torch.randint(1, N_ITEMS, (256,), generator=g, device=dev,
                      dtype=torch.int32)
    a = ops.eval_fused(x, y, t, 10, c_lo=1, c_hi=N_ITEMS, with_lse=True)
    b = ops.eval_fused(x, y, t, 10, c_lo=1, c_hi=N_ITEMS, with_lse=True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("n_q,c,d", [(8, 3_000, 36), (33, 2_000, 20),
                                     (130, 1_500, 12), (9, 1_000, 8)])
def test_sweep_depth_padding_matches_plain(dev, n_q, c, d):
    """d % 8 ≠ 0 (and d = 8): the k16 steps' zero padding past d, integer
    inputs bit for bit, with the plan's τ seeding (a pre-pass over a
    sampled quarter of the tiles where the catalog is large enough) and
    with a pre-pass forced onto a small catalog."""
    import dataclasses

    g = _gen(dev, n_q + c + d)
    q, y = _ints(g, dev, n_q, d), _ints(g, dev, c, d)
    valid = torch.rand(c, generator=g, device=dev) > 0.2
    want = ref.mips_topk_ref(q, y, 10, valid=valid, id_offset=4)
    got = kernel.mips_topk(q, y, 10, valid=valid, id_offset=4)
    _assert_match(got, want, 0.0, True)
    own_plan = kernel.sweep_plan
    try:
        kernel.sweep_plan = lambda *a: dataclasses.replace(
            own_plan(*a), pre_split=own_plan(*a).n_split,
            pre_period=4 * own_plan(*a).n_split)
        got = kernel.mips_topk(q, y, 10, valid=valid, id_offset=4)
    finally:
        kernel.sweep_plan = own_plan
    _assert_match(got, want, 0.0, True)


def test_train_state_restores_onto_cuda_with_the_generator(dev, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.sce import make_bucket_centers
    from repro_torch.data import Cursor
    from repro_torch.launch.elastic import TrainState
    from repro_torch.optim.optimizers import adamw, tree_leaves

    opt_init, opt_update = adamw(1e-3)
    g = _gen(dev, 4)
    params = {"w": torch.randn(64, 8, generator=g, device=dev)}
    params, opt_state = opt_update({"w": torch.ones(64, 8, device=dev)},
                                   opt_init(params), params)
    torch.randn(1000, generator=g, device=dev)  # mid-stream
    state = TrainState(params=params, opt_state=opt_state, generator=g,
                       cursor=Cursor(seed=0, step=3), step=3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state.to_ckpt(), blocking=False)
    mgr.wait()
    step, tree = mgr.restore_latest(device=dev)
    assert step == 3 and mgr.unverified_loads == 0
    back = TrainState.from_ckpt(tree, opt_template=opt_init(params))
    assert back.generator.device.type == "cuda"
    assert torch.equal(back.generator.get_state(), g.get_state())
    x = torch.randn(256, 8, generator=_gen(dev, 5), device=dev)
    want = make_bucket_centers(x, 16, use_mix=True, generator=g)
    got = make_bucket_centers(x, 16, use_mix=True, generator=back.generator)
    assert torch.equal(got, want)
    assert back.params["w"].is_cuda
    assert torch.equal(back.params["w"], params["w"])
    for a, b in zip(tree_leaves(back.opt_state), tree_leaves(opt_state)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The deep variants' slabs: a score budget small enough for several slabs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [10, 320, 1_024])
def test_deep_mips_topk_in_several_slabs_matches_plain(dev, monkeypatch, k):
    """The queries in slabs of 16 rows (``deep.SLAB_BYTES`` patched down): the
    ids and values equal the plain version's bit for bit on integers, and
    each slab's collect counts land in ``last_counts``."""
    g = _gen(dev, k)
    q, y = _ints(g, dev, 70, 300), _ints(g, dev, 3_000, 300)
    monkeypatch.setattr(deep, "SLAB_BYTES", 4 * 3_000 * 16)
    assert kernel.slab_rows(70, 3_000) == 16
    got = ops.mips_topk(q, y, k)
    torch.cuda.synchronize()
    _assert_match(got, ref.mips_topk_ref(q, y, k), 1.0, True)
    if k > kernel.SMALL_K:
        assert kernel.mips_topk.last_counts.shape == (70,)


def test_deep_eval_fused_in_several_slabs_matches_plain(dev, monkeypatch):
    """eval_fused at d 2304 in slabs of 16 rows, k 1 with the LSE and cap
    30 (the token-rank protocol): ids, counts and the threshold equal the
    plain version's bit for bit on integers, the LSE within 1e-5."""
    x, y, t = _eval_problem(dev, 5, 50, 2_000, 2_304, True, 0, 1, 1_990)
    monkeypatch.setattr(deep, "SLAB_BYTES", 4 * 2_000 * 16)
    kw = dict(c_lo=1, c_hi=1_990, logit_softcap=30.0, with_lse=True)
    got = ops.eval_fused(x, y, t, 1, **kw)
    want = ref.eval_fused_ref(x, y, t, 1, **kw)
    for a, b in zip(got[:5], want[:5]):
        assert torch.equal(a, b)
    assert torch.allclose(got[5] + torch.log(got[6]),
                          want[5] + torch.log(want[6]), rtol=1e-5, atol=0)


def _on_slab(s, k, *, c_lo=None, c_hi=None, targets=None, tgt=None,
             valid=None):
    """The deep sweep's outputs computed by PyTorch from its slab ``s``
    (C, n): the top-k by (value descending, lower id first) over the
    valid columns (``ID_PAD`` past them), and with ``tgt`` the counts with
    the self-column rule. ``valid`` (C,) bool, or the window."""
    c, n = s.shape
    gid = torch.arange(c, device=s.device)
    if valid is None:
        valid = (gid >= c_lo) & (gid < c_hi)
    sv = torch.where(valid[:, None], s, torch.tensor(-1e30, device=s.device))
    order = torch.argsort(sv.T, dim=1, descending=True, stable=True)[:, :k]
    vals = torch.gather(sv.T, 1, order)
    ids = torch.where(vals == -1e30, ID_PAD, order).to(torch.int32)
    if tgt is None:
        return vals, ids
    self_ = gid[:, None] == targets[None, :].long()
    gt = ((sv > tgt) & ~self_).sum(0).to(torch.int32)
    eq = ((sv == tgt) | (self_ & valid[:, None])).sum(0).to(torch.int32)
    return vals, ids, gt, eq


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,k,c_lo,c_hi,rows", [
    (37, 1_000, 1, 1, 1_000, None),     # C not a multiple of 64
    (5, 50, 3, 0, 50, None),            # C below one tile
    (130, 3_001, 10, 70, 2_990, None),  # n not a multiple of 32, a window
    (70, 2_000, 1, 1, 1_990, 16),       # several slabs of 16 rows
])
def test_deep_sweep_equals_pytorch_on_its_own_slab(dev, monkeypatch, dtype,
                                                   n, c, k, c_lo, c_hi,
                                                   rows):
    """The deep sweep that reads the score slab through its ring of TMA
    boxes: ``eval_fused`` (cap 30, the LSE), ``eval_topk`` and the deep
    ``mips_topk`` (k ≤ 32) at d 300 give, on the slab that the kernels
    score (``eval_fused.score_slab``: a score does not depend on its
    slab's other rows), the values, ids, ``gt``, ``eq`` and target score
    of PyTorch on that slab bit for bit, and ``(m, s)`` within
    ``1e-5·max + 2e-4·|·|`` of f64 (``lse`` within 1e-5 relative); a
    second launch repeats every output bit for bit."""
    g = _gen(dev, n + c)
    x = torch.randn(n, 300, generator=g, device=dev).to(dtype)
    y = (0.5 * torch.randn(c, 300, generator=g, device=dev)).to(dtype)
    t = torch.randint(max(0, c_lo - 3), min(c, c_hi + 3), (n,),
                      generator=g, device=dev, dtype=torch.int32)
    if rows is not None:
        monkeypatch.setattr(deep, "SLAB_BYTES", 4 * c * rows)
        assert kernel.slab_rows(n, c) == rows
    s = eval_kernel.score_slab(x, y)
    tgt = s[t.long(), torch.arange(n, device=dev)]
    kw = dict(c_lo=c_lo, c_hi=c_hi, logit_softcap=30.0, with_lse=True)
    got = ops.eval_fused(x, y, t, k, **kw)
    assert all(torch.equal(a, b)
               for a, b in zip(got, ops.eval_fused(x, y, t, k, **kw)))
    assert torch.equal(got[4].view(torch.int32), tgt.view(torch.int32))
    want = _on_slab(s, k, c_lo=c_lo, c_hi=c_hi, targets=t, tgt=tgt)
    for a, b in zip(got[:4], want):
        assert torch.equal(a, b)
    gid = torch.arange(c, device=dev)
    ok = (gid >= c_lo) & (gid < c_hi)
    lv = torch.where(ok[:, None], 30.0 * torch.tanh(s.double() / 30.0),
                     -math.inf)
    m64 = lv.amax(0)
    s64 = torch.exp(lv - m64).sum(0)
    for v, w in ((got[5], m64), (got[6], s64)):
        assert ((v.double() - w).abs()
                <= 1e-5 * w.abs().max() + 2e-4 * w.abs()).all()
    lse = got[5].double() + torch.log(got[6].double())
    lse64 = m64 + torch.log(s64)
    assert ((lse - lse64).abs() <= 1e-5 * lse64.abs()).all()
    # eval_topk: the same sweep without the self-column rule or the LSE
    two = topk_kernel.eval_topk(x, y, tgt, k, c_lo=c_lo, c_hi=c_hi)
    assert all(torch.equal(a, b) for a, b in zip(
        two, topk_kernel.eval_topk(x, y, tgt, k, c_lo=c_lo, c_hi=c_hi)))
    want = _on_slab(s, k, c_lo=c_lo, c_hi=c_hi,
                    targets=torch.full_like(t, -1), tgt=tgt)
    for a, b in zip(two, want):
        assert torch.equal(a, b)
    # the deep mips_topk at k ≤ 32 over a mask
    valid = torch.rand(c, generator=g, device=dev) > 0.3
    sel = kernel.mips_topk(x, y, k, valid=valid)
    again = kernel.mips_topk(x, y, k, valid=valid)
    assert torch.equal(sel[0], again[0]) and torch.equal(sel[1], again[1])
    want = _on_slab(s, k, valid=valid)
    assert torch.equal(sel[0], want[0]) and torch.equal(sel[1], want[1])


def test_deep_kernels_repeat_bit_for_bit(dev):
    """At d 2304 two launches of mips_topk (k 1024), eval_fused and the SCE
    forward, dX and dY give the same bits."""
    g = _gen(dev, 11)
    q = torch.randn(20, 2_304, generator=g, device=dev)
    y = torch.randn(3_000, 2_304, generator=g, device=dev)
    a, b = ops.mips_topk(q, y, 1_024), ops.mips_topk(q, y, 1_024)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    t = torch.randint(1, 3_000, (20,), generator=g, device=dev,
                      dtype=torch.int32)
    e1 = ops.eval_fused(q, y, t, 1, with_lse=True, logit_softcap=30.0)
    e2 = ops.eval_fused(q, y, t, 1, with_lse=True, logit_softcap=30.0)
    assert all(torch.equal(u, v) for u, v in zip(e1, e2))
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 12, 2, 33, 100,
                                                  2_304, 400)
    lse = sce_prefetch.sce_gather_fwd(x_b, y, idx, tgt, cand, pos,
                                      logit_softcap=30.0)[1]
    gg = torch.rand(pos.shape, generator=g, device=dev)
    args = (x_b, y, idx, tgt, cand, lse, gg)
    for fn in (sce_prefetch.sce_gather_dx, sce_prefetch.sce_gather_dy):
        assert torch.equal(fn(*args, logit_softcap=30.0),
                           fn(*args, logit_softcap=30.0))


@pytest.mark.parametrize("d", [300, 2_304])
def test_deep_sce_backward_from_one_cotangent_equals_each_alone(dev, d):
    """The deep backward autograd runs (one launch: the logits and their
    cotangent written once, then dX and dY's slot rows from it) gives the
    bits dX and dY give each alone, for the gathered kernels and the
    bucket twins; each wrapper's counter moves by one."""
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 13 + d, 2, 33, 100,
                                                  d, 400)
    lse = sce_prefetch.sce_gather_fwd(x_b, y, idx, tgt, cand, pos,
                                      logit_softcap=30.0)[1]
    gg = torch.rand(pos.shape, generator=_gen(dev, 14), device=dev)
    args = (x_b, y, idx, tgt, cand, lse, gg)
    fns = (sce_prefetch.sce_gather_dx, sce_prefetch.sce_gather_dy)
    before = [f.launches for f in fns]
    both = sce_prefetch._grads(*fns, args, 30.0, True, True)
    assert [f.launches for f in fns] == [n + 1 for n in before]
    alone = [f(*args, logit_softcap=30.0) for f in fns]
    assert all(torch.equal(a, b) for a, b in zip(both, alone))
    y_b = y[idx.long()]
    bargs = (x_b, y_b, tgt, cand, lse, gg)
    fns = (sce_bucket.sce_bucket_dx, sce_bucket.sce_bucket_dy)
    before = [f.launches for f in fns]
    both = sce_bucket._bwd(*bargs, 30.0, True, True)
    assert [f.launches for f in fns] == [n + 1 for n in before]
    alone = [f(*bargs, logit_softcap=30.0) for f in fns]
    assert all(torch.equal(a, b) for a, b in zip(both, alone))


# ---------------------------------------------------------------------------
# The deep product (csrc/deep_tc.cuh) and the full-CE deep variants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,n,k", [(130, 70, 300), (33, 260, 2_304),
                                   (5, 7, 37)])
@pytest.mark.parametrize("a_km,b_kn,gather,acc",
                         list(itertools.product((False, True), repeat=4)))
def test_deep_tc_product_matches_plain(dev, m, n, k, a_km, b_kn, gather,
                                       acc):
    """Every operand option of the deep product — A M-major, B N-major, B
    gathered by id (clamped: ids −1 and past the table), the accumulate
    epilogue, zeroed rows (with A M-major, as dY's slots) — at ragged
    shapes (a row and a column tile past 128; K = 37, where no row is 16
    bytes: the 4-byte copies) against the plain version in f64, within
    ``1e-5·max|C|`` plus ``2e-4·|C|``; a second launch gives the same
    bits."""
    g = _gen(dev, m + n + k + 16 * a_km + 8 * b_kn + 4 * gather + 2 * acc)
    t = 2
    a = torch.randn((t, k, m) if a_km else (t, m, k), generator=g,
                    device=dev)
    rows = 50
    idx = None
    if gather:
        b = torch.randn((rows, n) if b_kn else (rows, k), generator=g,
                        device=dev)
        idx = torch.randint(-2, rows + 2, (t, k if b_kn else n),
                            generator=g, device=dev, dtype=torch.int32)
    else:
        b = torch.randn((t, k, n) if b_kn else (t, n, k), generator=g,
                        device=dev)
    m_zero = None
    if a_km:
        m_zero = torch.randint(-1, 3, (t, m), generator=g, device=dev,
                               dtype=torch.int32)
    out0 = torch.randn(t, m, n, generator=g, device=dev) if acc else None
    kw = dict(a_km=a_km, b_kn=b_kn, idx=idx, m_zero=m_zero)
    before = linear_sce.deep_tc_product.launches
    got = linear_sce.deep_tc_product(
        a, b, out=None if out0 is None else out0.clone(), **kw)
    again = linear_sce.deep_tc_product(
        a, b, out=None if out0 is None else out0.clone(), **kw)
    torch.cuda.synchronize()
    assert linear_sce.deep_tc_product.launches == before + 2
    want = ref.deep_tc_ref(a.double(), b.double(),
                           out=None if out0 is None else out0.double(), **kw)
    _close(got, want.float(), rtol=2e-4)
    assert torch.equal(got, again)
    if m_zero is not None:
        assert (got[m_zero < 0] == (out0[m_zero < 0] if acc else 0)).all()


def _deep_ce(dev, monkeypatch, n, c, d, chunk):
    """A deep full-CE problem in several catalog chunks (``deep.SLAB_BYTES``
    patched down to ``chunk`` rows, the last ragged) with a target in the
    last chunk and, at rows 1 and 2, targets outside ``[0, C)``."""
    monkeypatch.setattr(deep, "SLAB_BYTES", 4 * n * chunk)
    assert linear_sce.deep_chunk(n, c) == chunk and c % chunk
    x, w, t, gr = _ce_problem(dev, n + c + d, n, c, d, zero_rows=True)
    t[0] = c - 1
    t[1], t[2] = -1, c + 3
    return x, w, t, gr


@pytest.mark.parametrize("n,c,d,chunk", [(70, 1_037, 288, 256),
                                         (33, 700, 2_304, 128)])
@pytest.mark.parametrize("family,cap", [("linear", None), ("linear", 30.0),
                                        ("fused_lse", None),
                                        ("fused_ce", None)])
def test_deep_full_ce_matches_plain(dev, monkeypatch, n, c, d, chunk, family,
                                    cap):
    """Above d 256 ``ops.linear_ce_loss`` (with and without cap 30),
    ``ops.fused_lse`` and ``ops.fused_ce_loss`` run the deep entries:
    forward, dX and dW/dY against autograd through the plain versions in
    f64 (logits of 3·sqrt(d) make the f32 plain version's own rounding
    the larger error, as for the deep SCE), at the d ≤ 256 tolerances;
    one launch each of the forward, dX and dW/dY counters; rows with
    g = 0 exactly 0 in dX."""
    x, w, t, gr = _deep_ce(dev, monkeypatch, n, c, d, chunk)
    before = _ce_launches()
    leaves = [a.clone().requires_grad_(True) for a in (x, w)]
    fns = {"linear": lambda a, b: ops.linear_ce_loss(a, b, t,
                                                     logit_softcap=cap),
           "fused_lse": lambda a, b: ops.fused_lse(a, b),
           "fused_ce": lambda a, b: ops.fused_ce_loss(
               a, b, t.clamp(0, c - 1))}
    plain = {"linear": lambda a, b: ref.linear_ce_loss_ref(
                 a, b, t, logit_softcap=cap),
             "fused_lse": lambda a, b: ref.fused_lse_ref(a, b),
             "fused_ce": lambda a, b: ref.fused_ce_loss_ref(
                 a, b, t.clamp(0, c - 1))}
    out = fns[family](*leaves)
    got = torch.autograd.grad((out * gr).sum(), leaves)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_ce_launches(), before)]
    assert moved == ([1, 1, 1, 0, 0, 0] if family == "linear"
                     else [0, 0, 0, 1, 1, 1])
    exact = [a.double().requires_grad_(True) for a in (x, w)]
    want_out = plain[family](*exact)
    want = torch.autograd.grad((want_out * gr.double()).sum(), exact)
    _close(out.detach(), want_out.detach().float())
    for a, b in zip(got, want):
        _close(a, b.float(), rtol=2e-4)
    assert (got[0][gr == 0] == 0).all()


def test_deep_full_ce_repeats_bit_for_bit(dev, monkeypatch):
    """Two calls of each deep entry (the forward with and without the
    pluck, the backward for dX, dW and both) give the same bits, and the
    backward's dX and dW from one launch equal each alone."""
    x, w, t, gr = _deep_ce(dev, monkeypatch, 70, 1_037, 300, 256)
    for pl in (t, None):
        a, b = (linear_sce._fwd(x, w, pl, 30.0 if pl is not None else None)
                for _ in range(2))
        assert all(u is None and v is None or torch.equal(u, v)
                   for u, v in zip(a, b))
        lse = a[1]
        pair = linear_sce._bwd_deep(x, w, pl, lse, gr, None, True, True)
        assert all(torch.equal(u, v) for u, v in zip(
            pair, linear_sce._bwd_deep(x, w, pl, lse, gr, None, True, True)))
        assert torch.equal(pair[0], linear_sce._dx(x, w, pl, lse, gr, None))
        assert torch.equal(pair[1], linear_sce._dw(x, w, pl, lse, gr, None))


# ---------------------------------------------------------------------------
# bfloat16 operands: every family, resident and deep
# ---------------------------------------------------------------------------
def _bf16(*ts):
    """The tensors rounded to bfloat16 (the bf16 operands) and their
    widened f32 copies (what the f32 kernels get)."""
    bf = tuple(t.to(torch.bfloat16) for t in ts)
    return bf, tuple(t.float() for t in bf)


def _close_bf16(got, want):
    """A bf16 output against the plain version's: the type, and within
    the reference's bf16 tolerance (``tests/test_kernels.py``: 3e-2) of
    the largest value — one rounding of an f32 sum, and a cotangent
    rounded to bf16 on either side of a tie."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.double(), want.double()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= 3e-2 * w.abs().max().item()).all(), \
        (g - w).abs().max().item()


def _f64_tol(want, scale):
    """The deep product's tolerance against f64: 1e-5·max|·| + 2e-4·|·|."""
    return 1e-5 * scale + 2e-4 * want.abs()


def _hold_topk_f64(got, s64, k):
    """A deep bf16 selection (values, ids) against the f64 plain version's
    top-``k`` of the masked scores ``s64 (n, C)`` (invalid columns at
    -inf): values within :func:`_f64_tol`, ids equal wherever the
    reference's value lies further than that from its neighbours, the
    (k+1)-th included (ties go to the lower id)."""
    order = torch.sort(s64, dim=1, descending=True, stable=True).indices
    v = torch.gather(s64, 1, order)
    wv, wi = v[:, :k], order[:, :k].to(torch.int32)
    real = torch.isfinite(wv)
    scale = s64[torch.isfinite(s64)].abs().max().item()
    tol = _f64_tol(wv, scale)
    gv = got[0].double()
    assert (((gv - wv).abs() <= tol) | ~real).all(), \
        ((gv - wv).abs()[real].max().item(), scale)
    assert (got[1][~real] == ID_PAD).all()
    inf = torch.full_like(wv[:, :1], float("inf"))
    nxt = v[:, k:k + 1] if k < s64.shape[1] else -inf
    prv = torch.cat([inf, wv[:, :-1]], 1)
    nxt = torch.cat([wv[:, 1:], nxt], 1)
    iso = ((prv - wv) > tol) & ((wv - nxt) > tol) & real
    assert iso.any() and torch.equal(got[1][iso], wi[iso])


@pytest.mark.parametrize("n_q,c,d,k", [
    (8, 5_000, 64, 10),      # the tensor-core sweep, pre-pass
    (33, 4_100, 64, 10),
    (37, 1_100, 33, 10),     # d % 4 != 0: 2-byte loads
    (40, 3_000, 64, 320),    # the k > 32 chain
    (20, 2_000, 64, 512),
    (33, 3_000, 300, 10),    # deep: the slab on deep_tc, then the sweep
    (33, 3_000, 301, 200),   # odd d: rows not 16-byte aligned
    (20, 4_096, 2_304, 128),  # gemma-2's positions selection
    (12, 5_000, 2_304, 1_024),  # ... and its vocabulary selection
    (16, 3_000, 64, 1_024),  # the deep chain at a resident depth
    (128, 4_096, 2_304, 128),  # the positions selection: 32 tiles
    (128, 131 * 128, 2_304, 128),  # 131 tiles: just below the SMs
    (128, 133 * 128, 2_304, 128),  # 133 tiles: just above
    (128, 4_096, 1_536, 128),  # granite's positions selection
    (128, 49_168, 1_536, 512),  # ... its vocabulary: a ragged last tile
])
def test_bf16_mips_topk_equals_f32_on_widened_inputs(dev, n_q, c, d, k):
    """bf16 q and y. Resident: values and ids equal the f32 kernel's on the
    widened inputs bit for bit (each value exact in f32 and TF32, each
    product exact in f32). Deep (the score slab on ``gemm_bf16``):
    values within ``1e-5·max|·| + 2e-4·|·|`` of the f64
    plain version on the widened inputs, ids equal wherever the gap is
    above that. Either way a second launch repeats them bit for bit, and
    the plain version on the bf16 inputs agrees within 1e-5 of the
    largest score."""
    g = _gen(dev, n_q + c + d + k)
    (q, y), (qw, yw) = _bf16(torch.randn(n_q, d, generator=g, device=dev),
                             torch.randn(c, d, generator=g, device=dev))
    vm = torch.rand(c, generator=g, device=dev) > 0.2
    got = kernel.mips_topk(q, y, k, valid=vm)
    again = kernel.mips_topk(q, y, k, valid=vm)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    for a, c_ in zip(got, again):
        assert torch.equal(a, c_)
    if deep.is_deep(d, k):
        s64 = qw.double() @ yw.double().T
        _hold_topk_f64(got, torch.where(vm[None, :], s64, -math.inf), k)
    else:
        want = kernel.mips_topk(qw, yw, k, valid=vm)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    _assert_match(got, ref.mips_topk_ref(q, y, k, valid=vm),
                  (qw @ yw.T).abs().max().item(), False)


@pytest.mark.parametrize("n,c,d,k,cap,deep_", [
    (128, 20_000, 64, 10, 30.0, False),
    (40, 1_037, 33, 17, None, False),
    (40, 3_000, 300, 10, 30.0, True),
    (40, 3_000, 301, 10, None, True),   # odd d: 2-byte target loads
    (64, 5_000, 2_304, 1, 30.0, True),  # token rank
    (64, 49_168, 1_536, 1, None, True),  # granite's: ragged, no cap
])
def test_bf16_eval_equals_f32_on_widened_inputs(dev, n, c, d, k, cap, deep_):
    """eval_fused (vals, ids, gt, eq, tgt and the LSE pair),
    eval_tgt_gather, eval_topk and eval_tgt_scores on bf16 x and y.
    Resident: equal to the f32 kernels on the widened inputs bit for bit.
    Deep (the score slab on ``gemm_bf16``): values and the LSE pair within
    ``1e-5·max|·| + 2e-4·|·|`` of the f64 plain version on the widened
    inputs, ids equal wherever the gap is above that, gt within the
    columns that close to the target; eval_tgt_gather and eval_tgt_scores
    equal the slab's own column bit for bit (read through
    ``eval_fused.score_slab``, the launch's own slab), so eq counts it.
    Either way a second launch repeats every output bit for bit."""
    x, y, t = _eval_problem(dev, n + c, n, c, d, False, 0, 1, c - 10)
    (x, y), (xw, yw) = _bf16(x, y)
    kw = dict(c_lo=1, c_hi=c - 10, logit_softcap=cap, with_lse=True)
    got = eval_kernel.eval_fused(x, y, t, k, **kw)
    again = eval_kernel.eval_fused(x, y, t, k, **kw)
    assert torch.equal(eval_kernel.eval_tgt_gather(x, y, t), got[4])
    tk = topk_kernel.eval_topk(x, y, got[4], k, c_lo=1, c_hi=c - 10)
    tk_again = topk_kernel.eval_topk(x, y, got[4], k, c_lo=1, c_hi=c - 10)
    ts = topk_kernel.eval_tgt_scores(x, y, t)
    torch.cuda.synchronize()
    for a, c_ in zip(got, again):
        assert torch.equal(a, c_)
    for a, c_ in zip(tk, tk_again):
        assert torch.equal(a, c_)
    assert torch.equal(ts, topk_kernel.eval_tgt_scores(x, y, t))
    assert eval_kernel.eval_fused.launches > 0
    if not deep_:
        want = eval_kernel.eval_fused(xw, yw, t, k, **kw)
        tk_w = topk_kernel.eval_topk(xw, yw, want[4], k, c_lo=1,
                                     c_hi=c - 10)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for a, b in zip(tk, tk_w):
            assert torch.equal(a, b)
        assert torch.equal(ts, topk_kernel.eval_tgt_scores(xw, yw, t))
        return
    slab = eval_kernel.score_slab(x, y)  # (C, n): the launch's own slab
    owned = (t >= 0) & (t < c)
    rows = torch.arange(n, device=dev)
    col = torch.where(owned, slab[t.long().clamp(0, c - 1), rows], 0.0)
    assert torch.equal(got[4].view(torch.int32), col.view(torch.int32))
    assert torch.equal(ts.view(torch.int32), col.view(torch.int32))
    ids = torch.arange(c, device=dev)
    valid = (ids >= 1) & (ids < c - 10)
    s64 = xw.double() @ yw.double().T
    sv = torch.where(valid[None, :], s64, -math.inf)
    _hold_topk_f64(got[:2], sv, k)
    assert torch.equal(tk[0], got[0]) and torch.equal(tk[1], got[1])
    scale = s64.abs().max().item()
    tgt64 = torch.where(owned, (xw.double() * yw[t.long().clamp(
        0, c - 1)].double()).sum(1), 0.0)
    assert ((got[4].double() - tgt64).abs()
            <= _f64_tol(tgt64, scale)).all()
    self_ = ids[None, :] == t[:, None].long()
    near = ((sv - tgt64[:, None]).abs() <= _f64_tol(tgt64, scale)[:, None])
    gt64 = ((sv > tgt64[:, None]) & ~self_).sum(1)
    assert ((got[2] - gt64).abs() <= near.sum(1)).all()
    live = owned & (t >= 1) & (t < c - 10)
    assert (got[3][live] >= 1).all() and (tk[3][live] >= 1).all()
    lv = s64 if cap is None else cap * torch.tanh(s64 / cap)
    lv = torch.where(valid[None, :], lv, -math.inf)
    m64 = lv.amax(1)
    s_64 = torch.exp(lv - m64[:, None]).sum(1)
    assert ((got[5].double() - m64).abs() <= _f64_tol(m64, m64.abs().max()
                                                        .item())).all()
    assert ((got[6].double() - s_64).abs() <= _f64_tol(s_64, s_64.abs()
                                                         .max().item())).all()


@pytest.mark.parametrize("shape,cap", [
    ((3, 100, 50, 16, 257), None),
    ((5, 23, 50, 36, 300), 30.0),
    ((2, 33, 100, 2_304, 400), 30.0),  # deep
])
def test_bf16_sce_forwards_equal_f32_on_widened_inputs(dev, shape, cap):
    """The gathered and direct SCE forwards and partial LSEs on bf16 x_b
    and y: the lse / plse equal the f32 kernels' on the widened inputs bit
    for bit, the loss is their f32 loss rounded to bf16 (pos_logit's
    type), and a second launch repeats them. Deep (d > 256), the logits
    come from the bf16 product (``gemm_bf16``: the depth summed in the
    tensor cores, other bits than the f32 kernels' 3xTF32 steps): there
    the lse / plse lie within ``1e-5·max|·| + 2e-4·|·|`` of the f64 plain
    version on the widened inputs, the loss is the kernel's lse − pos
    rounded to bf16, and a second launch repeats them bit for bit."""
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, sum(shape), *shape)
    (x_b, y, pos), (xw, yw, pw) = _bf16(x_b, y, pos)
    deep_ = deep.is_deep(shape[3])
    kw = dict(logit_softcap=cap)

    def equal_or_f64(got, want, f64):
        if deep_:
            _close(got, f64.float(), rtol=2e-4)
        else:
            assert torch.equal(got, want)

    xd, yd, pd = xw.double(), yw.double(), pw.double()
    got = sce_prefetch.sce_gather_fwd(x_b, y, idx, tgt, cand, pos, **kw)
    want = sce_prefetch.sce_gather_fwd(xw, yw, idx, tgt, cand, pw, **kw)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    equal_or_f64(got[1], want[1], ref.sce_gather_loss_ref(
        xd, yd, idx, tgt, cand, pd, cap) + pd)
    assert torch.equal(got[0], (want[0] if not deep_ else got[1] - pw)
                       .to(torch.bfloat16))
    again = sce_prefetch.sce_gather_fwd(x_b, y, idx, tgt, cand, pos, **kw)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    plse = sce_prefetch.sce_gather_plse_fwd(x_b, y, idx, tgt, cand, **kw)
    equal_or_f64(plse, sce_prefetch.sce_gather_plse_fwd(
        xw, yw, idx, tgt, cand, **kw), ref.sce_gather_plse_ref(
        xd, yd, idx, tgt, cand, cap))
    assert torch.equal(plse, sce_prefetch.sce_gather_plse_fwd(
        x_b, y, idx, tgt, cand, **kw))
    rows = idx.long().clamp(0, y.shape[0] - 1)
    y_b, yw_b = y[rows].contiguous(), yw[rows].contiguous()
    b_got = sce_bucket.sce_bucket_fwd(x_b, y_b, tgt, cand, pos, **kw)
    b_want = sce_bucket.sce_bucket_fwd(xw, yw_b, tgt, cand, pw, **kw)
    equal_or_f64(b_got[1], b_want[1], ref.sce_bucket_loss_ref(
        xd, yd[rows], tgt, cand, pd, cap) + pd)
    assert torch.equal(b_got[0], (b_want[0] if not deep_ else b_got[1] - pw)
                       .to(torch.bfloat16))
    b_plse = sce_bucket.sce_bucket_plse_fwd(x_b, y_b, tgt, cand, **kw)
    equal_or_f64(b_plse, sce_bucket.sce_bucket_plse_fwd(
        xw, yw_b, tgt, cand, **kw), ref.sce_bucket_plse_ref(
        xd, yd[rows], tgt, cand, cap))
    assert torch.equal(b_plse, sce_bucket.sce_bucket_plse_fwd(
        x_b, y_b, tgt, cand, **kw))
    _close_bf16(got[0], ref.sce_gather_loss_ref(x_b, y, idx, tgt, cand, pos,
                                                cap))
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape,cap", [
    ((3, 100, 50, 16, 257), None),
    ((5, 23, 50, 36, 300), 30.0),
    ((4, 70, 64, 64, 200), None),
    ((2, 33, 100, 2_304, 400), 30.0),  # deep: one backward launch
    ((2, 16, 24, 2_304, 50), None),
    ((2, 128, 512, 1_536, 49_168), None),  # granite: its ragged bf16 table
])
def test_bf16_sce_backwards_match_plain(dev, shape, cap):
    """Autograd through the SCE loss, the partial LSE and their sce_bucket
    twins on bf16 leaves: gradients in the leaves' types, within the bf16
    tolerance of the plain versions (which round the cotangent to bf16 as
    the kernels and the reference do), and repeating bit for bit."""
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, sum(shape) + 1,
                                                  *shape)
    x_b = x_b * 3.0
    (x_b, y, pos), _ = _bf16(x_b, y, pos)
    up = torch.rand(pos.shape, generator=_gen(dev, 5), device=dev)

    def grads(fn, leaves, *rest):
        ls = [t.clone().requires_grad_(True) for t in leaves]
        out = fn(*ls[:2], *rest, *ls[2:])
        return out, torch.autograd.grad((out.float() * up).sum(), ls)

    y_b = y[idx.long().clamp(0, y.shape[0] - 1)].contiguous()
    cases = (
        (lambda a, b, *r: ops.sce_gather_loss(a, b, *r, logit_softcap=cap),
         lambda a, b, *r: ref.sce_gather_loss_ref(a, b, *r, cap),
         (x_b, y, pos), (idx, tgt, cand)),
        (lambda a, b, *r: ops.sce_gather_plse(a, b, *r, logit_softcap=cap),
         lambda a, b, *r: ref.sce_gather_plse_ref(a, b, *r, cap),
         (x_b, y), (idx, tgt, cand)),
        (lambda a, b, *r: ops.sce_bucket_loss(a, b, *r, logit_softcap=cap),
         lambda a, b, *r: ref.sce_bucket_loss_ref(a, b, *r, cap),
         (x_b, y_b, pos), (tgt, cand)),
    )
    for fn, plain, leaves, rest in cases:
        out, got = grads(fn, leaves, *rest)
        _, again = grads(fn, leaves, *rest)
        want_out, want = grads(plain, leaves, *rest)
        _close_bf16(out.detach(), want_out.detach())
        for a, b, c_ in zip(got, want, again):
            assert a.dtype == torch.bfloat16
            _close_bf16(a, b)
            assert torch.equal(a, c_)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,c,d,cap", [
    (300, 5_000, 64, 30.0),     # resident: planes with lo 0
    (129, 3_001, 40, None),
    (70, 1_037, 288, None),     # deep
    (33, 2_000, 2_304, 30.0),
    (256, 49_168, 1_536, None),  # granite's full CE: a ragged last chunk
])
def test_bf16_full_ce_matches(dev, n, c, d, cap):
    """linear_ce_loss and fused_lse on bf16 x and w: the forward's lse
    equals the f32 kernel's on the widened inputs bit for bit and the loss
    is its f32 loss rounded to bf16; dX and dW (dY) in the operands'
    types within the bf16 tolerance of the plain versions (cotangent
    rounded to bf16), repeating bit for bit. Deep (d > 256), the logits
    come from the bf16 product (other bits than the f32 kernels' 3xTF32
    steps): there the loss and lse lie within ``1e-5·max|·| + 2e-4·|·|``
    of the f64 plain versions on the widened inputs and repeat bit for
    bit."""
    x, w, t, gr = _ce_problem(dev, n + c + d, n, c, d)
    (x, w), (xw, ww) = _bf16(x, w)
    loss, lse = linear_sce.linear_ce_fwd(x, w, t, logit_softcap=cap)
    loss_w, lse_w = linear_sce.linear_ce_fwd(xw, ww, t, logit_softcap=cap)
    if deep.is_deep(d):
        xd, wd = xw.double(), ww.double()
        _close(lse, ref.fused_lse_ref(xd, wd, logit_softcap=cap).float(),
               rtol=2e-4)
        _close(loss, ref.linear_ce_loss_ref(xd, wd, t, logit_softcap=cap)
               .float(), rtol=2e-4)
        again = linear_sce.linear_ce_fwd(x, w, t, logit_softcap=cap)
        assert torch.equal(loss, again[0]) and torch.equal(lse, again[1])
        f_lse = fused_ce.fused_lse_fwd(x, w)
        _close(f_lse, ref.fused_lse_ref(xd, wd).float(), rtol=2e-4)
        assert torch.equal(f_lse, fused_ce.fused_lse_fwd(x, w))
    else:
        assert torch.equal(lse, lse_w) and torch.equal(loss, loss_w)
        assert torch.equal(fused_ce.fused_lse_fwd(x, w),
                           fused_ce.fused_lse_fwd(xw, ww))
    if d <= 256:  # the split: each bf16 value its own hi, lo 0
        xp, _ = linear_sce.linear_ce_split(x, w)
        assert torch.equal(xp, ref.tf32x3_planes_ref(xw))
        assert (xp[:, :, 1] == 0).all()
    for fn, plain in (
            (lambda a, b: ops.linear_ce_loss(a, b, t, logit_softcap=cap),
             lambda a, b: ref.linear_ce_loss_ref(a, b, t,
                                                 logit_softcap=cap)),
            (lambda a, b: ops.fused_lse(a, b),
             lambda a, b: ref.fused_lse_ref(a, b))):
        outs = []
        for f in (fn, fn, plain):
            ls = [x.clone().requires_grad_(True),
                  w.clone().requires_grad_(True)]
            out = f(*ls)
            outs.append((out.detach(), torch.autograd.grad(
                (out.float() * gr).sum(), ls)))
        (o1, g1), (_, g2), (ow, gw) = outs
        assert o1.dtype == ow.dtype
        _close_bf16(o1, ow)
        for a, b, c_ in zip(g1, gw, g2):
            assert a.dtype == torch.bfloat16
            _close_bf16(a, b)
            assert torch.equal(a, c_)
    torch.cuda.synchronize()


@pytest.mark.parametrize("t,m,n,k,a_km,b_kn", [
    (1, 4_096, 128, 2_304, False, False),  # the score slab: C rows as A
    (2, 300, 77, 37, False, False),
    (2, 130, 200, 300, True, False),
    (3, 129, 140, 41, False, True),
    (1, 257, 131, 520, True, True),
    (2, 200, 136, 64, True, True),    # 16-byte rows: every operand by TMA
    (2, 256, 384, 320, False, True),
])
def test_bf16_deep_tc_product(dev, t, m, n, k, a_km, b_kn):
    """deep_tc.cuh on bf16 operands at ragged shapes, in each orientation
    the slabs and gradients use: the bf16 product (``gemm_bf16``, the
    score slab's product too), with and without B
    gathered by clamped id (ids −2 and past the table) and the accumulate
    epilogue, zeroed rows with A M-major, rows 16-byte aligned (the TMA;
    gathered, cp.async) or not (the register-staged copies): within the
    f32 deep product's ``1e-5·max|C| + 2e-4·|C|`` of the f64 plain
    version and repeating bit for bit; the f32 three-pass product on the
    widened operands within the same tolerance."""
    g = _gen(dev, m + n + k)
    a = torch.randn((t, k, m) if a_km else (t, m, k), generator=g,
                    device=dev)
    b = torch.randn((t, k, n) if b_kn else (t, n, k), generator=g,
                    device=dev)
    (a, b), (aw, bw) = _bf16(a, b)
    kw = dict(a_km=a_km, b_kn=b_kn)
    three = linear_sce.deep_tc_product(aw, bw, **kw)
    torch.cuda.synchronize()
    _close(three, ref.deep_tc_ref(aw.double(), bw.double(), **kw).float(),
           rtol=2e-4)
    rows = 50
    tab = torch.randn((rows, n) if b_kn else (rows, k), generator=g,
                      device=dev).to(torch.bfloat16)
    idx = torch.randint(-2, rows + 2, (t, k if b_kn else n), generator=g,
                        device=dev, dtype=torch.int32)
    m_zero = (torch.randint(-1, 3, (t, m), generator=g, device=dev,
                            dtype=torch.int32) if a_km else None)
    out0 = torch.randn(t, m, n, generator=g, device=dev)
    for gather, acc in itertools.product((False, True), repeat=2):
        bb = tab if gather else b
        okw = dict(kw, idx=idx if gather else None, m_zero=m_zero)
        before = linear_sce.deep_tc_product.launches
        got = linear_sce.deep_tc_product(
            a, bb, out=out0.clone() if acc else None, **okw)
        again = linear_sce.deep_tc_product(
            a, bb, out=out0.clone() if acc else None, **okw)
        torch.cuda.synchronize()
        assert linear_sce.deep_tc_product.launches == before + 2
        assert torch.equal(got, again)
        want = ref.deep_tc_ref(a.double(), bb.double(),
                               out=out0.double() if acc else None, **okw)
        _close(got, want.float(), rtol=2e-4)
        if m_zero is not None:
            assert (got[m_zero < 0] == (out0[m_zero < 0] if acc else 0)).all()


def test_bf16_refusals(dev):
    """A bf16 / f32 mix, float64 and float16 raise TypeError in every
    family and in the deep product alone."""
    q = torch.zeros(4, 64, device=dev)
    y = torch.zeros(20, 64, device=dev)
    t = torch.zeros(4, dtype=torch.int32, device=dev)
    for a, b in ((q.bfloat16(), y), (q, y.bfloat16()), (q.half(), y.half()),
                 (q.double(), y.double())):
        with pytest.raises(TypeError):
            kernel.mips_topk(a, b, 3)
        with pytest.raises(TypeError):
            eval_kernel.eval_tgt_gather(a, b, t)
        with pytest.raises(TypeError):
            linear_sce.linear_ce_fwd(a, b, t)
    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 4, 2, 16, 24, 8, 100)
    with pytest.raises(TypeError):
        sce_prefetch.sce_gather_fwd(x_b.bfloat16(), y, idx, tgt, cand, pos)
    with pytest.raises(TypeError):
        sce_bucket.sce_bucket_fwd(x_b.bfloat16(), y[idx.long()].half(), tgt,
                                  cand, pos)
    a = torch.zeros(1, 8, 16, device=dev, dtype=torch.bfloat16)
    for b in (a.float(), a.half()):
        with pytest.raises(TypeError):
            linear_sce.deep_tc_product(a, b)


def test_bf16_forward_lse_is_the_fold_of_the_backward_logits(dev, monkeypatch):
    """Deep bf16 SCE (gathered and bucket twins) and full CE: the logits the
    backward recomputes (left in its f32 workspace; the bf16 cotangent goes
    to its own buffer) equal the forward's bit for bit, so the forward's
    lse is the fold of the backward's logits: one product, one rounding.
    The lse lies within 1e-6 relative of that fold in f64."""
    wss = []
    real_ws, real_slab = sce_prefetch._logits_ws, linear_sce._slab

    def logits_ws(shape, device):
        wss.append(real_ws(shape, device))
        return wss[-1]

    def slab(shape, dtype, device):
        out = real_slab(shape, dtype, device)
        wss.append(out[0])
        return out

    monkeypatch.setattr(sce_prefetch, "_logits_ws", logits_ws)
    monkeypatch.setattr(sce_bucket, "_logits_ws", logits_ws)
    monkeypatch.setattr(linear_sce, "_slab", slab)
    x_b, y, idx, tgt, cand, _ = _gather_problem(dev, 21, 2, 33, 100, 2_304,
                                                400)
    (x_b, y), _ = _bf16(x_b, y)
    g = torch.rand(2, 33, generator=_gen(dev, 22), device=dev)
    plse = sce_prefetch.sce_gather_plse_fwd(x_b, y, idx, tgt, cand,
                                            logit_softcap=30.0)
    fwd = wss.pop().clone()
    sce_prefetch._grads(sce_prefetch.sce_gather_plse_dx,
                        sce_prefetch.sce_gather_plse_dy,
                        (x_b, y, idx, tgt, cand, plse, g), 30.0, True, True)
    assert torch.equal(wss.pop(), fwd)
    lg = fwd.view(2, 33, 100).double()
    lg = 30.0 * torch.tanh(lg / 30.0)
    hide = (cand[:, None, :] < 0) | (cand[:, None, :] == tgt[:, :, None])
    fold = torch.logsumexp(torch.where(hide, -math.inf, lg), -1)
    assert torch.allclose(plse.double(), fold, rtol=1e-6, atol=0)
    y_b = y[idx.long()].contiguous()
    lse = sce_bucket.sce_bucket_plse_fwd(x_b, y_b, tgt, cand)
    fwd = wss.pop().clone()
    sce_bucket._bwd(x_b, y_b, tgt, cand, lse, g, None, True, True)
    assert torch.equal(wss.pop(), fwd)
    x, w, t, gr = _ce_problem(dev, 23, 70, 1_037, 2_304)
    (x, w), _ = _bf16(x, w)
    loss, lse = linear_sce._fwd(x, w, t, 30.0)
    fwd = wss.pop()[:, :1_037].clone()  # one chunk: every logit
    linear_sce._bwd_deep(x, w, t, lse, gr, 30.0, True, True)
    assert torch.equal(wss.pop()[:, :1_037], fwd)
    lg = 30.0 * torch.tanh(fwd.double() / 30.0)
    assert torch.allclose(lse.double(), torch.logsumexp(lg, -1), rtol=1e-6,
                          atol=0)
    assert torch.allclose(loss.double(), torch.logsumexp(lg, -1)
                          - lg.gather(1, t.long()[:, None])[:, 0],
                          rtol=1e-5, atol=1e-5)


def test_bf16_dy_sum_is_the_f32_sum_rounded_once(dev):
    """``sce_gather_dy_sum`` into a bf16 table equals its sum into an f32
    table rounded to bf16 bit for bit (each row's f32 sum, in ascending
    slot order, rounded once), rows no slot selected exactly 0; and
    ``dy_sum_plain`` with ``dtype=bf16`` agrees within one bf16 rounding
    (its ``index_add_`` adds in another order on the card)."""
    g = _gen(dev, 24)
    n_b, b_y, d, c = 6, 300, 2_304, 900
    ws = torch.randn(n_b * b_y, d, generator=g, device=dev)
    idx = torch.randint(-2, c + 2, (n_b, b_y), generator=g, device=dev,
                        dtype=torch.int32)
    cand = idx.clone()
    cand[:, ::5] = -1
    keys = sce_prefetch.dy_sum_keys(idx, cand, c)
    f32 = sce_prefetch.sce_gather_dy_sum(ws, *keys, torch.zeros(
        c, d, device=dev))
    before = sce_prefetch.sce_gather_dy_sum.launches
    bf = sce_prefetch.sce_gather_dy_sum(ws, *keys, torch.zeros(
        c, d, device=dev, dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert sce_prefetch.sce_gather_dy_sum.launches == before + 1
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, f32.to(bf.dtype))
    plain = sce_prefetch.dy_sum_plain(ws, idx, cand, c, torch.bfloat16)
    _close_bf16(bf, plain)


@pytest.mark.parametrize("d", [300, 2_304])
def test_bf16_deep_entries_launch_the_bf16_product(dev, d):
    """On bf16 operands the deep SCE forward and one-launch backward and
    the deep full-CE forward and backward run ``gemm_bf16_kernel`` and
    never the depth-chunked TF32 ``gemm_kernel``, at a depth whose rows
    are 16-byte aligned (2304: the TMA) and one whose rows are not (300:
    the register-staged copies) — no route back to the one-TF32 pass."""
    from torch.profiler import ProfilerActivity, profile

    x_b, y, idx, tgt, cand, pos = _gather_problem(dev, 25, 2, 33, 100, d,
                                                  400)
    (x_b, y, pos), _ = _bf16(x_b, y, pos)
    x, w, t, gr = _ce_problem(dev, 26, 70, 1_037, d)
    (x, w), _ = _bf16(x, w)
    leaves = [a.clone().requires_grad_(True) for a in (x_b, y, x, w)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = sce_prefetch.sce_gather_loss(leaves[0], leaves[1], idx, tgt,
                                           cand, pos, logit_softcap=30.0)
        out2 = linear_sce.linear_ce_loss(leaves[2], leaves[3], t)
        torch.autograd.grad(out.float().sum() + out2.float().sum(), leaves)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert [n for n in names if "deep_tc::gemm_bf16_kernel" in n], names
    assert not [n for n in names if "deep_tc::gemm_kernel" in n], names


# ---------------------------------------------------------------------------
# BERT4Rec's train step and the seqrec serve steps on the card
# ---------------------------------------------------------------------------
def _bert4rec_cfg(which):
    from repro_torch.configs import get_arch
    from repro_torch.models import bert4rec

    if which == "smoke":
        return get_arch("bert4rec").make_smoke_config()
    # the published width and depth on a 20,000-item catalog
    return bert4rec.make_config(n_items=20_000, max_len=50)


@pytest.mark.parametrize("which", ["smoke", "wide"])
def test_bert4rec_step_on_the_card_matches_plain(dev, which):
    """One BERT4Rec SCE step (the cloze mask and Ω injected, the same
    weights) on the card's kernels and on the CPU's plain versions: the
    loss and grad norm within ``1e-5`` relative, the params within
    ``1e-5·max|p|`` but where Adam turns a near-zero gradient's f32 noise
    into a full ±lr step (``2·lr``)."""
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.launch import steps
    from repro_torch.models import bert4rec
    from repro_torch.optim.optimizers import tree_leaves

    cfg = _bert4rec_cfg(which)
    batch = 2
    arch = get_arch("bert4rec")
    shape = ShapeSpec("train_smoke", "train", {"batch": batch})
    tokens = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=batch,
    )).next_batch(Cursor(seed=2))[0]["tokens"]
    g = torch.Generator().manual_seed(3)
    cloze = torch.rand(batch, cfg.max_len, generator=g)
    out = {}
    for where in ("cpu", dev):
        step, (opt_init, _), sce_cfg = steps.make_seqrec_train_step(
            arch, cfg, shape)
        omega = torch.randn(sce_cfg.n_buckets, batch * cfg.max_len,
                            generator=torch.Generator().manual_seed(4))
        params = bert4rec.init_params(cfg, seed=0, device=where)
        launches = kernel.mips_topk.launches
        params, _, m = step(
            params, opt_init(params),
            {"tokens": torch.from_numpy(tokens).to(where)},
            omega=omega.to(where), cloze=cloze.to(where))
        out[str(where)] = (float(m["loss"]), float(m["grad_norm"]),
                           [p.cpu() for p in tree_leaves(params)],
                           kernel.mips_topk.launches - launches)
    (lc, gc_, pc, nc), (lg, gg, pg, ng) = out["cpu"], out[str(dev)]
    assert nc == 0 and ng == 2  # the card's step selected on the kernel
    assert math.isfinite(lg) and lg == pytest.approx(lc, rel=1e-5)
    assert gg == pytest.approx(gc_, rel=1e-5)
    for a, b in zip(pg, pc):
        diff = (a - b).abs()
        assert bool((diff <= 2 * 1e-3).all())
        assert (diff > 1e-5 * b.abs().max()).float().mean().item() < 0.01


@pytest.mark.parametrize("which", ["smoke", "wide"])
def test_serve_steps_on_the_card_match_plain(dev, which):
    """The three seqrec serve steps of a BERT4Rec model on the card
    against the same steps on the CPU's plain versions: values within
    ``1e-5·max|score|``, ids (or candidate positions) equal wherever the
    neighbouring scores are further apart; tied copies lower id first."""
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.launch import steps
    from repro_torch.models import bert4rec

    cfg = _bert4rec_cfg(which)
    hist = torch.from_numpy(SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=12,
    )).next_batch(Cursor(seed=5))[0]["tokens"])
    g = torch.Generator().manual_seed(6)
    cand = torch.randint(0, cfg.n_items, (cfg.n_items // 2,), generator=g,
                         dtype=torch.int32)
    cand[-50:] = cand[:50]  # repeated candidates tie exactly
    params = {where: bert4rec.init_params(cfg, seed=1, device=where)
              for where in ("cpu", dev)}
    for where in params:  # 80 copied rows: exact ties between ids
        emb = params[where]["item_emb"]
        emb[cfg.n_items // 2:cfg.n_items // 2 + 80] = emb[1:81]
    runs = (
        (steps.make_seqrec_mips_serve_step(cfg, top_k=10), ()),
        (steps.make_seqrec_serve_step(cfg), ()),
        (steps.make_seqrec_retrieval_step(cfg), (cand,)),
    )
    for step, extra in runs:
        h = hist[:1] if extra else hist  # retrieval: one user
        before = kernel.mips_topk.launches
        got = step(params[dev], h.to(dev), *(e.to(dev) for e in extra))
        assert kernel.mips_topk.launches == before + 1
        want = step(params["cpu"], h, *extra)
        got = tuple(t.cpu() for t in got)
        scale = want[0].abs().max().item()
        _assert_match(got, want, scale, False)
        tie = got[0][:, 1:] == got[0][:, :-1]
        assert bool((got[1][:, 1:][tie] > got[1][:, :-1][tie]).all())


def test_granite_moe_block_on_the_card_matches_cpu(dev):
    """granite's MoE block at its widths (d 1536, 40 experts padded to
    48, top-8, d_ff 512; 1,024 tokens, capacity 256, bf16 weights and
    input, offset by 1 so that some experts overflow) on the card against
    the same block on the CPU. The router's
    input lies on a grid of 1/8 and its weights on one of 1/64, so its
    f32 logits are exact on both devices and both route alike: expert
    ids, ranks, keep masks and dispatch indices equal exactly, the
    combine weights within 1e-6. The output and the gradients of
    ``sum(y · w) + aux`` (bf16 products in another order) within the
    bf16 tolerance of the CPU's, aux within 1e-5 relative, and a second
    run on the card repeats every value bit for bit (no atomics in the
    combine)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    cfg = get_arch("granite-moe-3b-a800m").make_config().moe
    d, n = 1_536, 1_024
    g = torch.Generator().manual_seed(7)
    params = moe.init_moe(g, d, cfg, dtype=torch.bfloat16)
    params["router"] = torch.randint(-64, 65, params["router"].shape,
                                     generator=g).float() / 64
    # a shared offset makes some experts popular: assignments drop
    x = (torch.randint(-16, 17, (1, n, d), generator=g).float() / 8
         + 1).to(torch.bfloat16)
    w = torch.randn(1, n, d, generator=g).to(torch.bfloat16)

    def run(where):
        leaves = {k: v.to(where).requires_grad_(True)
                  for k, v in params.items()}
        xx = x.to(where).requires_grad_(True)
        y, aux = moe.apply_moe(leaves, xx, cfg)
        names = sorted(leaves)
        grads = torch.autograd.grad(
            (y.float() * w.to(where).float()).sum() + aux,
            [xx] + [leaves[k] for k in names])
        probs = torch.softmax(torch.einsum(
            "bld,de->ble", xx.detach().float(), leaves["router"].detach()),
            -1)
        r = moe.dispatch(probs, cfg, cfg.capacity(n))
        return [y.detach(), aux.detach(), *grads], r

    got, r_dev = run(dev)
    again, _ = run(dev)
    want, r_cpu = run("cpu")
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for field in ("expert", "rank", "keep", "dispatch_idx"):
        assert torch.equal(getattr(r_dev, field).cpu(), getattr(r_cpu, field))
    assert (r_dev.weight.cpu() - r_cpu.weight).abs().max() <= 1e-6
    assert int((~r_cpu.keep).sum()) > 0  # capacity 256 drops some
    assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-5)
    for a, b in zip([got[0]] + got[2:], [want[0]] + want[2:]):
        _close_bf16(a.cpu(), b)


def test_moe_lm_step_on_the_card_matches_plain(dev):
    """One SCE ``exact`` step of granite's smoke LM (2 sequences of 32
    tokens, the Mix draw injected, the same weights) on the card's
    kernels and on the CPU's plain versions: loss and grad norm within
    ``1e-5`` relative, the parameters within ``1e-5·max|p|`` but where
    Adam turns a near-zero gradient's f32 noise into a full ±lr step."""
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    arch = get_arch("granite-moe-3b-a800m")
    cfg = arch.make_smoke_config()
    batch, seq = 2, 32
    shape = ShapeSpec("train_smoke", "train",
                      {"global_batch": batch, "seq_len": seq})
    host = SequenceDataset(SeqDataConfig(
        n_items=cfg.vocab, seq_len=seq, batch_size=batch,
        min_len_frac=1.0)).next_batch(Cursor(seed=2))[0]
    out = {}
    for where in ("cpu", dev):
        step, (opt_init, _), sce_cfg = steps.make_lm_train_step(
            arch, cfg, shape, mesh=make_host_mesh(max_data=batch),
            sce_mode="exact")
        omega = torch.randn(sce_cfg.n_buckets, batch * seq,
                            generator=torch.Generator().manual_seed(4))
        params = tree_map(lambda t: t.to(where), transformer.init_params(
            cfg, seed=0, device="cpu"))
        launches = kernel.mips_topk.launches
        batch_t = {k: torch.from_numpy(v).to(where) for k, v in host.items()}
        params, _, m = step(params, opt_init(params), batch_t,
                            omega=omega.to(where))
        out[str(where)] = (float(m["loss"]), float(m["grad_norm"]),
                           [p.cpu() for p in tree_leaves(params)],
                           kernel.mips_topk.launches - launches)
    (lc, gc_, pc, nc), (lg, gg, pg, ng) = out["cpu"], out[str(dev)]
    assert nc == 0 and ng == 2  # the card's step selected on the kernel
    assert math.isfinite(lg) and lg == pytest.approx(lc, rel=1e-5)
    assert gg == pytest.approx(gc_, rel=1e-5)
    for a, b in zip(pg, pc):
        diff = (a - b).abs()
        assert bool((diff <= 2 * 3e-4).all())
        assert (diff > 1e-5 * b.abs().max()).float().mean().item() < 0.01


# ---------------------------------------------------------------------------
# The sharded paths' local stages: a 4-way merge against one launch
# ---------------------------------------------------------------------------
def _shard_problem(dev, seed, n, c, d, dtype):
    g = _gen(dev, seed)
    x = torch.randn(n, d, generator=g, device=dev).to(dtype)
    y = (torch.randn(c, d, generator=g, device=dev) * 0.3).to(dtype)
    per = c // 4
    y[3 * per + 5:3 * per + 9] = y[7:11]  # rows tied across shards
    t = torch.randint(1, c - 9, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    t[:4] = torch.arange(3 * per + 5, 3 * per + 9, device=dev)
    return x, y, t, [(y[j * per:(j + 1) * per], j * per) for j in range(4)]


@pytest.mark.parametrize("n,c,d,k,dtype,with_lse,cap", [
    (100, 4 * 2_500, 64, 10, torch.float32, False, None),
    (64, 4 * 1_000, 64, 10, torch.float32, True, 30.0),
    (96, 4 * 3_000, 300, 1, torch.bfloat16, True, 30.0),
    (40, 4 * 800, 2_304, 5, torch.bfloat16, False, None),
])
def test_sharded_eval_merge_equals_unsharded(dev, n, c, d, k, dtype,
                                             with_lse, cap):
    from repro_torch.dist.collectives import (merge_gathered_lse,
                                              merge_gathered_topk)

    x, y, t, blocks = _shard_problem(dev, 31, n, c, d, dtype)
    kw = dict(c_lo=1, c_hi=c - 9, logit_softcap=cap, with_lse=with_lse)
    whole = ops.eval_fused(x, y, t, k, **kw)
    tgt = torch.stack([ops.eval_tgt_gather(x, y_j, t, id_offset=off)
                       for y_j, off in blocks]).sum(0)
    outs = [ops.eval_fused(x, y_j, t, k, tgt_scores=tgt, id_offset=off, **kw)
            for y_j, off in blocks]
    vals, ids = merge_gathered_topk(torch.stack([o[0] for o in outs]),
                                    torch.stack([o[1] for o in outs]), k)
    got = (vals, ids, sum(o[2] for o in outs), sum(o[3] for o in outs), tgt)
    for a, b in zip(got, whole[:5]):
        assert torch.equal(a, b)
    if with_lse:
        lse = merge_gathered_lse(torch.stack([o[5] for o in outs]),
                                 torch.stack([o[6] for o in outs]))
        want = whole[5] + torch.log(whole[6])
        assert ((lse - want).abs() / want.abs()).max().item() <= 1e-5


@pytest.mark.parametrize("n,c,d,k,dtype,c_lo", [
    (512, 4 * 2_500, 64, 10, torch.float32, 1),
    (33, 4 * 2_000, 64, 100, torch.float32, 0),
    (16, 4 * 1_500, 2_304, 128, torch.bfloat16, 1),
])
def test_sharded_mips_topk_merge_equals_unsharded(dev, n, c, d, k, dtype,
                                                  c_lo):
    from repro_torch.dist.collectives import merge_gathered_topk
    from repro_torch.eval.streaming import streaming_topk

    x, y, _, blocks = _shard_problem(dev, 32, n, c, d, dtype)
    whole = streaming_topk(x, y, k, c_lo=c_lo, c_hi=c - 9)
    outs = [streaming_topk(x, y_j, k, c_lo=c_lo, c_hi=c - 9, id_offset=off)
            for y_j, off in blocks]
    got = merge_gathered_topk(torch.stack([o[0] for o in outs]),
                              torch.stack([o[1] for o in outs]), k)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)


def _launch_counts():
    """Every kernel wrapper's launch counter (the recsys and GNN paths
    must move none)."""
    return {name: getattr(mod, name).launches
            for mod in (eval_kernel, topk_kernel, fused_ce, linear_sce,
                        kernel, sce_bucket, sce_prefetch)
            for name in dir(mod)
            if isinstance(getattr(getattr(mod, name), "launches", None), int)}


@pytest.mark.parametrize("name", ["dcn-v2", "dlrm-rm2", "xdeepfm"])
def test_recsys_forward_on_the_card_matches_f64(dev, name):
    """A CTR model at its published dense widths (each field's table cut
    to 2,000 rows) on the card against the same forward on f64 copies of
    the weights: 5,000 rows (two blocks of xDeepFM's CIN), logits within
    ``1e-5·max|l|`` (f32 fold order), the BCE within ``1e-5`` relative,
    the serve step's probabilities (chunks of 2,048 rows) within ``2e-6``;
    no kernel of the port launches."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import ClickDataConfig, ClickstreamDataset, Cursor
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    from repro_torch.optim.optimizers import tree_map

    arch = get_arch(name)
    cfg = dataclasses.replace(arch.make_config(), vocab_sizes=tuple(
        min(v, 2_000) for v in arch.make_config().vocab_sizes))
    b = ClickstreamDataset(ClickDataConfig(
        vocab_sizes=cfg.vocab_sizes, batch_size=5_000,
        n_dense=getattr(cfg, "n_dense", 1))).next_batch(Cursor(seed=1))[0]
    dense, sparse, labels = (torch.from_numpy(b[k]).to(dev)
                             for k in ("dense", "sparse_ids", "labels"))
    params = steps.RECSYS_INIT[name](cfg, seed=0, device=dev)
    p64 = tree_map(lambda p: p.double(), params)
    fwd = steps.recsys_forward_fn(name)
    before = _launch_counts()
    with torch.no_grad():
        got = fwd(params, cfg, dense, sparse)
        want = fwd(p64, cfg, dense.double(), sparse)
        probs = steps.make_recsys_serve_step(arch, cfg, chunk=2_048)(
            params, dense, sparse)
    assert _launch_counts() == before
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert (got.double() - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()
    loss = recsys.bce_logits_loss(got, labels).item()
    assert loss == pytest.approx(
        recsys.bce_logits_loss(want, labels.double()).item(), rel=1e-5)
    assert (probs.double() - torch.sigmoid(want)).abs().max().item() <= 2e-6


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm"])
def test_schnet_on_the_card_matches_f64(dev, shape):
    """SchNet at ``make_config(shape)`` on the card against f64 copies of
    the same weights and graph: 128 molecules of 30 nodes and 64 bonds,
    or the 2,708-node graph with its 10,556 directed edges padded to
    multiples of 512 (``edge_valid`` off on the padding): energies within
    ``1e-5·max|e|``, every parameter's gradient of the regime's MSE within
    ``1e-4·max|g|`` (``index_add`` adds with atomics on the card: the
    order of the sums differs from run to run); no kernel of the port
    launches."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.data import (Cursor, GraphDataConfig, batched_molecules,
                                  random_graph)
    from repro_torch.launch.steps import _unflatten
    from repro_torch.models import schnet
    from repro_torch.optim.optimizers import tree_leaves

    cfg = get_arch("schnet").make_config(shape)
    if shape == "molecule":
        g, _ = batched_molecules(Cursor(seed=2), n_mols=128,
                                 nodes_per_mol=30, edges_per_mol=64,
                                 d_feat=cfg.d_feat)
        ev = None
    else:
        g = random_graph(GraphDataConfig(n_nodes=2_708, n_edges=5_278,
                                         d_feat=cfg.d_feat, seed=2))
        e = g["edge_index"].shape[1]
        pad = -(-e // 512) * 512 - e
        g["edge_index"] = np.pad(g["edge_index"], ((0, 0), (0, pad)))
        ev = torch.from_numpy(np.arange(e + pad) < e).to(dev)
    feats, pos, ei = (torch.from_numpy(g[k]).to(dev)
                      for k in ("node_feats", "positions", "edge_index"))
    params = schnet.init_params(cfg, seed=3, device=dev)
    out = {}
    before = _launch_counts()
    for dt in (torch.float32, torch.float64):
        leaves = [p.to(dt).requires_grad_(True) for p in tree_leaves(params)]
        p = _unflatten(params, leaves)
        if shape == "molecule":
            e_, _ = schnet.forward(p, cfg, feats.to(dt), pos.to(dt), ei,
                                   torch.from_numpy(g["graph_ids"]).to(dev),
                                   128)
            loss = torch.square(
                e_ - torch.from_numpy(g["targets"]).to(dev, dt)).mean()
        else:
            e_, _ = schnet.node_energies(p, cfg, feats.to(dt), pos.to(dt),
                                         ei, ev)
            loss = torch.square(
                e_ - torch.from_numpy(g["targets"]).to(dev, dt)).mean()
        out[dt] = (e_.detach(), torch.autograd.grad(loss, leaves))
    assert _launch_counts() == before
    (e32, g32), (e64, g64) = out[torch.float32], out[torch.float64]
    assert (e32.double() - e64).abs().max().item() <= \
        1e-5 * e64.abs().max().item()
    for a, w in zip(g32, g64):
        assert (a.double() - w).abs().max().item() <= \
            1e-4 * w.abs().max().item()
