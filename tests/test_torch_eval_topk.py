"""The port's deprecated two-pass evaluation (``eval_topk`` /
``eval_tgt_scores``) against the JAX package's (``kernels/eval_topk.py``).

The port's plain versions (``ref.eval_topk_ref`` /
``ref.eval_tgt_scores_ref``, the CPU path of ``ops`` and the yardsticks
of the CUDA kernels) are held against ``repro.kernels.ref``'s: target
scores and top-k values within ``1e-5·max|score|`` (f32 sums in another
fold order), ids exactly wherever neighbouring values are further apart
than that. ``gt``/``eq`` are held against a dense f64 torch oracle's band
(scores within the tolerance of the threshold may fall on either side),
not against ``repro``'s counts, which are off by one on jax 0.9.0
(ROADMAP queue 3). Within the port, ``eval_tgt_scores_ref`` is bit for
bit the column ``eval_topk_ref`` sweeps (``eq >= 1`` on every row whose
target is valid), and a sum over catalog shards assembles it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.topk_merge import ID_PAD

CASES = [  # (B, C, d, k, chunk, c_lo, c_hi, id_offset, ties)
    (16, 300, 8, 10, 64, 1, 290, 0, False),
    (9, 257, 33, 17, 50, 3, 240, 0, True),  # ragged chunks, tied rows
    (12, 40, 16, 50, 16, 2, 30, 0, False),  # k > valid columns
    (10, 120, 8, 5, 32, 1_010, 1_100, 1_000, False),  # a shard's id_offset
]


def _problem(seed, b, c, d, c_lo, c_hi, id_offset, ties):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d)).astype(np.float32)
    y = rng.standard_normal((c, d)).astype(np.float32)
    if ties:
        y[c // 2:c // 2 + 20] = y[:20]
    t = rng.integers(max(c_lo, id_offset), min(c_hi, id_offset + c),
                     b).astype(np.int32)
    t[0] = id_offset + c + 3  # outside this shard: score 0
    return x, y, t


def _band(x, y, ts, c_lo, c_hi, id_offset, tol):
    """Dense f64 counts: scores surely above the threshold, and those
    above or within ``tol`` of it, over the valid columns."""
    s = torch.from_numpy(x).double() @ torch.from_numpy(y).double().T
    gid = id_offset + torch.arange(y.shape[0])
    ok = (gid >= c_lo) & (gid < c_hi)
    t = torch.from_numpy(ts).double()[:, None]
    return (((s > t + tol) & ok).sum(1).numpy(),
            ((s >= t - tol) & ok).sum(1).numpy(), s.abs().max().item())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_eval_topk_plain_matches_reference(case):
    b, c, d, k, chunk, c_lo, c_hi, off, ties = case
    x, y, t = _problem(b + c, b, c, d, c_lo, c_hi, off, ties)
    xt, yt, tt = map(torch.from_numpy, (x, y, t))
    with pytest.warns(DeprecationWarning):
        ts = ops.eval_tgt_scores(xt, yt, tt, block_c=chunk, id_offset=off)
    with pytest.warns(DeprecationWarning):
        vals, ids, gt, eq = ops.eval_topk(xt, yt, ts, k, block_c=chunk,
                                          c_lo=c_lo, c_hi=c_hi,
                                          id_offset=off)
    jts = np.asarray(jref.eval_tgt_scores_ref(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), chunk=chunk,
        id_offset=off))
    jv, ji, _, _ = (np.asarray(a) for a in jref.eval_topk_ref(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(jts), k, chunk=chunk,
        c_lo=c_lo, c_hi=c_hi, id_offset=off))
    scale = np.abs(x.astype(np.float64) @ y.astype(np.float64).T).max()
    tol = 1e-5 * scale
    np.testing.assert_allclose(ts.numpy(), jts, rtol=0, atol=tol)
    assert ts[0].item() == 0.0 and jts[0] == 0.0
    vals, ids, gt, eq = (a.numpy() for a in (vals, ids, gt, eq))
    real = jv > -1e29
    assert (real == (vals > -1e29)).all()
    np.testing.assert_allclose(vals[real], jv[real], rtol=0, atol=tol)
    assert (ids[~real] == ID_PAD).all() and (ji[~real] == ID_PAD).all()
    prv = np.concatenate([np.full((b, 1), np.inf), jv[:, :-1]], 1)
    nxt = np.concatenate([jv[:, 1:], np.full((b, 1), -np.inf)], 1)
    isolated = real & (prv - jv > tol) & (jv - nxt > tol)
    np.testing.assert_array_equal(ids[isolated], ji[isolated])
    lo, hi, _ = _band(x, y, ts.numpy(), c_lo, c_hi, off, tol)
    assert ((gt >= lo) & (gt + eq <= hi)).all()
    # the threshold is bit for bit the swept column
    valid = (t >= max(c_lo, off)) & (t < min(c_hi, off + c))
    assert (eq[valid] >= 1).all()
    hit = ids == t[:, None]
    assert (vals[hit] == np.broadcast_to(ts.numpy()[:, None], hit.shape)[hit]
            ).all()


def test_eval_tgt_scores_assembles_over_shards():
    """Each shard scores only its own targets (0 elsewhere): the sum over
    a 3-way catalog split is the whole catalog's score."""
    x, y, t = _problem(3, 20, 90, 8, 0, 90, 0, False)
    t[0] = 5
    xt, yt, tt = map(torch.from_numpy, (x, y, t))
    whole = ref.eval_tgt_scores_ref(xt, yt, tt, chunk=16)
    parts = [ref.eval_tgt_scores_ref(xt, yt[lo:lo + 30], tt, chunk=16,
                                     id_offset=lo) for lo in (0, 30, 60)]
    for lo, p in zip((0, 30, 60), parts):
        off = (t < lo) | (t >= lo + 30)
        assert (p.numpy()[off] == 0).all()
    torch.testing.assert_close(sum(parts), whole, rtol=0,
                               atol=1e-5 * whole.abs().max().item())


def test_eval_topk_is_eval_fused_without_the_self_rule():
    """Fed the same threshold, the two-pass sweep's top-k equals the fused
    sweep's; and since the threshold is bit for bit the target's swept
    column, the fused sweep's self-column rule changes no count."""
    x, y, t = _problem(5, 14, 200, 8, 1, 190, 0, True)
    xt, yt, tt = map(torch.from_numpy, (x, y, t))
    ts = ref.eval_tgt_scores_ref(xt, yt, tt, chunk=64)
    a = ref.eval_topk_ref(xt, yt, ts, 10, chunk=64, c_lo=1, c_hi=190)
    f = ref.eval_fused_ref(xt, yt, tt, 10, tgt_scores=ts, chunk=64, c_lo=1,
                           c_hi=190)
    assert torch.equal(a[0], f[0]) and torch.equal(a[1], f[1])
    assert torch.equal(a[2], f[2]) and torch.equal(a[3], f[3])
