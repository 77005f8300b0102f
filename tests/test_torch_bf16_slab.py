"""The deep ``mips_topk`` and the deep eval sweep on bfloat16 operands, in
the arithmetic of their score slab on the card, on the CPU.

On bf16 operands at d > 256 (and in ``mips_topk``'s chain above k 512)
the score slab ``S = Y · Qᵀ`` (catalog rows as A, queries as B, f32 out)
is ``csrc/deep_tc.cuh``'s ``gemm_bf16``: both operands read as stored,
every product exact, accumulated in f32 over k16 steps in ascending
depth, one product over the whole depth per score. ``eval_tgt_gather``
and ``eval_tgt_scores`` give the same product of the target pair, so a
target score is its slab column bit for bit. A CUDA kernel has no CPU
mode, so here, at d 288 and 300 and catalogs of a few thousand rows:

- the slab modelled by ``tests/test_torch_bf16_tc.py``'s plain model of
  the bf16 product (``_bf16_product``), within
  ``1e-5·max|S| + 2e-4·|S|`` of f64;
- the deep ``mips_topk`` (the sweep at k 10, the chain at k 128 and
  640) and the
  deep ``eval_fused`` with the LSE, computed from the modelled slab as
  the sweeps read it, against the JAX kernels in interpret mode at
  ``tests/test_torch_bf16.py``'s tolerance (3e-2 of each tensor's largest
  magnitude): ids equal wherever a value lies further than 1e-5 of the
  largest score from its neighbours (the (k+1)-th included; ties go to
  the lower id), counts equal;
- the modelled target score equal to the modelled slab's column bit for
  bit on every row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_bf16 as tb
import test_torch_bf16_tc as btc
from repro.kernels import eval_fused as jeval
from repro.kernels import guard as jguard
from repro.kernels import mips_topk as jmips
from repro_torch.kernels import ref

BF = torch.bfloat16
NEG_INF = -1e30


def _slab(q, y):
    """The bf16 score slab ``(C, n_q)`` as the card writes it
    (``_bf16_product``: catalog rows as A, queries as B)."""
    return btc._bf16_product(y, q)


def _select(s_t, k):
    """Top-``k`` of each row of ``s_t (n_q, C)`` under the merge key (value
    descending, lower id first): ``(vals, ids)`` and the (k+1)-th value."""
    order = torch.sort(s_t, dim=1, descending=True, stable=True).indices
    vals = torch.gather(s_t, 1, order)
    nxt = vals[:, k] if k < s_t.shape[1] else None
    return vals[:, :k], order[:, :k].to(torch.int32), nxt


def _ids_agree(gv, gi, wv, wi, w_next, tol):
    """Ids equal wherever the reference's value lies further than ``tol``
    from its neighbours, the (k+1)-th included; at least one such."""
    gv, wv = tb._np(gv), tb._np(wv)
    gi, wi = np.asarray(gi), np.asarray(wi)
    prv = np.concatenate([np.full_like(wv[:, :1], np.inf), wv[:, :-1]], 1)
    last = (np.full_like(wv[:, :1], -np.inf) if w_next is None
            else tb._np(w_next)[:, None])
    nxt = np.concatenate([wv[:, 1:], last], 1)
    iso = ((prv - wv) > tol) & ((wv - nxt) > tol)
    assert iso.any() and np.array_equal(gi[iso], wi[iso])


def _problem(seed, n_q, c, d):
    rng = np.random.default_rng(seed)
    q, jq = tb._bf16(rng, n_q, d)
    y, jy = tb._bf16(rng, c, d, scale=0.5)
    return rng, q, jq, y, jy


@pytest.mark.parametrize("d", [288, 300])
@pytest.mark.parametrize("n_q,c", [(6, 2_000), (130, 700), (1, 1),
                                   (128, 4_096)])
def test_slab_model_holds_f64(d, n_q, c):
    """The modelled slab lies within the deep product's tolerance of
    f64, from one pair to the positions selection's 128 × 4,096."""
    _, q, _, y, _ = _problem(d + n_q, n_q, c, d)
    want = y.double() @ q.double().T
    s = _slab(q, y)
    assert s.shape == (c, n_q) and s.dtype == torch.float32
    tol = 1e-5 * want.abs().max() + 2e-4 * want.abs()
    assert ((s.double() - want).abs() <= tol).all()


@pytest.mark.parametrize("d", [288, 300])
@pytest.mark.parametrize("k", [10, 128, 640])
def test_deep_bf16_mips_topk_model_matches_the_jax_kernel(d, k):
    """The sweep (k 10) and the chain (k 128, 640) read the slab; their
    values and ids against the JAX kernel (interpret mode) on the same
    bf16 inputs, with a mask (the (k+1)-th value: the model's)."""
    rng, q, jq, y, jy = _problem(d + k, 6, 1_500, d)
    valid = rng.random(1_500) > 0.2
    s_t = _slab(q, y).T.clone()
    s_t[:, ~torch.from_numpy(valid)] = NEG_INF
    vals, ids, nxt = _select(s_t, k)
    want = jmips.mips_topk(jq, jy, k, valid=jnp.asarray(valid),
                           block_q=8, block_c=512, interpret=True,
                           merge_impl="bitonic" if k > 32 else "rounds")
    tb._close(vals, want[0])
    scale = np.abs(tb._np(want[0])).max()
    _ids_agree(vals, ids, want[0], want[1], nxt, 1e-5 * scale)


def _eval_from_slab(s_t, targets, tgt, k, c_lo, c_hi, cap):
    """eval_fused's outputs from the swept scores ``s_t (n, C)``: top-k,
    gt / eq with the self-column rule, the capped LSE pair's lse."""
    c = s_t.shape[1]
    ids = torch.arange(c)
    valid = (ids >= c_lo) & (ids < c_hi)
    sv = torch.where(valid[None, :], s_t, torch.tensor(NEG_INF))
    self_ = ids[None, :] == targets[:, None].long()
    gt = ((sv > tgt[:, None]) & ~self_ & valid[None, :]).sum(1)
    eq = (((sv == tgt[:, None]) | self_) & valid[None, :]).sum(1)
    vals, top, _ = _select(sv, k)
    logits = cap * torch.tanh(s_t.double() / cap)
    lse = torch.logsumexp(torch.where(valid[None, :], logits,
                                      torch.tensor(-np.inf,
                                                   dtype=torch.float64)), 1)
    return vals, top, gt.to(torch.int32), eq.to(torch.int32), lse


@pytest.mark.parametrize("d", [288, 300])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_deep_bf16_eval_fused_model_matches_the_jax_kernel(d, k):
    """The eval slab and its target from the same
    arithmetic: top-k, gt, eq and the LSE (cap 30) against the JAX
    kernels (interpret mode) on the same bf16 inputs; eq ≥ 1 on every row
    (the target's column counts)."""
    n, c, c_lo, c_hi = 8, 1_200, 1, 1_150
    rng, x, jx, y, jy = _problem(d + 7 * k, n, c, d)
    t = rng.integers(c_lo, c_hi, n).astype(np.int32)
    tt = torch.from_numpy(t)
    slab = _slab(x, y)
    tgt = btc._bf16_product(y[tt.long()][:, None, :],
                            x[:, None, :])[:, 0, 0]
    got = _eval_from_slab(slab.T, tt, tgt, k, c_lo, c_hi, 30.0)
    kw = dict(c_lo=c_lo, c_hi=c_hi, with_lse=True, logit_softcap=30.0)
    jguard.set_policy("off")  # its CPU canaries fail (ROADMAP queue 3)
    try:
        want = jeval.eval_fused(jx, jy, jnp.asarray(t), k, block_b=8,
                                block_c=64, interpret=True, **kw)
    finally:
        jguard.set_policy(None)
    tb._close(got[0], want[0])
    tb._close(tgt, want[4])
    scale = np.abs(tb._np(want[0])).max()
    if k > 1:
        _ids_agree(got[0], got[1], want[0], want[1], None, 1e-5 * scale)
    else:  # one entry a row: it is the row's largest score
        gap = _select(slab.T.clone(), 2)[0]
        iso = (gap[:, 0] - gap[:, 1]).numpy() > 1e-5 * scale
        assert np.array_equal(got[1].numpy()[iso, 0],
                              np.asarray(want[1])[iso, 0])
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert (got[3] >= 1).all()
    wlse = np.asarray(want[5]) + np.log(np.asarray(want[6]))
    tb._close(got[4], wlse)
    np.testing.assert_allclose(got[4].numpy(), wlse, rtol=1e-5, atol=0)


@pytest.mark.parametrize("d", [288, 300])
@pytest.mark.parametrize("c", [700, 2_000])
def test_target_model_is_the_slab_column_bit_for_bit(d, c):
    """The target score of every row — the pair's product, as
    ``eval_tgt_gather`` / ``eval_tgt_scores`` compute it — equals the
    modelled eval slab's column for that pair, bit for bit; and the
    plain version ``ref.eval_tgt_gather_ref`` agrees within f32 rounding
    of f64."""
    rng, x, _, y, _ = _problem(d + c, 12, c, d)
    t = torch.from_numpy(rng.integers(0, c, 12).astype(np.int32))
    slab = _slab(x, y)
    tgt = btc._bf16_product(y[t.long()][:, None, :], x[:, None, :])[:, 0, 0]
    col = slab[t.long(), torch.arange(12)]
    assert torch.equal(tgt.view(torch.int32), col.view(torch.int32))
    plain = ref.eval_tgt_gather_ref(x, y, t)
    want = (x.double() * y[t.long()].double()).sum(1)
    assert ((tgt.double() - want).abs() <= 1e-5 * want.abs().max()).all()
    assert ((plain.double() - want).abs() <= 1e-5 * want.abs().max()).all()
