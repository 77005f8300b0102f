"""The port's plain ``eval_fused`` / ``eval_tgt_gather`` against the JAX
package's, and the port's own bitwise threshold property.

Both sides get the same numpy inputs (``repro.kernels.ref`` on the CPU,
the plain reference the JAX package's own CPU tests run).

Tolerances, and why:

* integer-valued inputs make every f32 fold order exact, so ``vals``,
  ``ids``, ``gt``, ``eq`` and ``tgt`` must agree bit for bit; the LSE
  (``m + log s``) folds ``exp`` in another order: ``1e-5`` relative;
* generic floats: the two frameworks fold the products in another order,
  so values and ``tgt`` agree within ``1e-5·max|score|``; ids agree where
  neighbouring values are further apart than that; ``gt``/``eq`` give a
  rank inside the band a dense f64 oracle allows (other valid scores
  within ``1e-5·max|score|`` of the target may fall on either side). The
  reference's own ``gt``/``eq`` are no bitwise oracle on this JAX (its
  same-shape-gemm claim fails here, ROADMAP.md queue 3), so the port's
  ranks are held against the f64 band, not against them.

Inside the port the threshold must be bitwise the swept target column:
that is checked directly against the sweep's own chunk products.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import eval_fused as kernel
from repro_torch.kernels.topk_merge import ID_PAD, NEG_INF

from _rank_band import f64_band

TOL = 1e-5


def _inputs(seed, n, c, d, integer, id_offset, c_lo, c_hi):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        y = rng.integers(-2, 3, size=(c, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        y = rng.normal(size=(c, d)).astype(np.float32)
    lo = max(c_lo, id_offset)
    t = rng.integers(lo, max(lo + 1, min(c_hi, id_offset + c)), size=n)
    if n >= 3:
        t[1] = id_offset + c + 4  # outside y's id range: tgt 0
        t[2] = c_lo - 1 if c_lo > id_offset else t[2]  # outside the window
    return x, y, t.astype(np.int32)


def _assert_topk(gv, gi, wv, wi, scale, exact):
    assert gv.shape == wv.shape and gi.dtype == np.int32
    if exact:
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gi, wi)
        return
    tol = TOL * scale
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol)
    prv = np.concatenate([np.full_like(wv[:, :1], np.inf), wv[:, :-1]], 1)
    nxt = np.concatenate([wv[:, 1:], np.full_like(wv[:, :1], -np.inf)], 1)
    isolated = ((prv - wv) > tol) & ((wv - nxt) > tol)
    np.testing.assert_array_equal(gi[isolated], wi[isolated])


CASES = [
    # n, c, d, k, integer, with_lse, cap, c_lo, c_hi, id_offset, chunk
    (16, 700, 32, 10, True, False, None, 1, 690, 0, 128),
    (16, 700, 32, 10, False, False, None, 1, 690, 0, 128),
    (12, 1037, 24, 10, True, True, None, 1, 1030, 0, 256),  # ragged C
    (12, 1037, 24, 10, False, True, 30.0, 1, 1030, 0, 256),
    (9, 500, 16, 12, True, True, None, 3, 9, 0, 64),  # k > valid columns
    (10, 600, 16, 8, False, True, 30.0, 1003, 1550, 1000, 128),  # offset
    (7, 64, 8, 70, True, True, 30.0, 0, None, 0, 512),  # k > C
    (0, 300, 16, 5, False, True, None, 1, 290, 0, 128),  # n == 0
]


@pytest.mark.parametrize(
    "n,c,d,k,integer,with_lse,cap,c_lo,c_hi,id_offset,chunk", CASES)
def test_eval_fused_ref_matches_jax(n, c, d, k, integer, with_lse, cap, c_lo,
                                    c_hi, id_offset, chunk):
    hi = id_offset + c if c_hi is None else c_hi
    x, y, t = _inputs(n * 31 + c, n, c, d, integer, id_offset, c_lo, hi)
    kw = dict(chunk=chunk, c_lo=c_lo, c_hi=c_hi, id_offset=id_offset,
              logit_softcap=cap, with_lse=with_lse)
    got = ref.eval_fused_ref(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(t), k, **kw)
    want = jax_ref.eval_fused_ref(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(t), k, **kw)
    g = [None if a is None else a.numpy() for a in got]
    w = [None if a is None else np.asarray(a) for a in want]
    assert g[0].shape == (n, k) and g[2].dtype == np.int32
    assert (g[5] is None) == (not with_lse) == (g[6] is None)
    if n == 0:
        return
    scale = float(np.abs(x.astype(np.float64) @ y.T.astype(np.float64)).max())
    _assert_topk(g[0], g[1], w[0], w[1], scale, integer)
    if integer:
        for name, a, b in zip(("gt", "eq", "tgt"), g[2:5], w[2:5]):
            np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(g[4], w[4], rtol=0, atol=TOL * scale)
        lo, hi_ = f64_band(x, y, t, c_lo, hi, id_offset, TOL * scale)
        ranks = g[2] + np.maximum(g[3] - 1, 0)
        assert ((ranks >= lo) & (ranks <= hi_)).all(), (ranks, lo, hi_)
    if with_lse:
        lse_g, lse_w = g[5] + np.log(g[6]), w[5] + np.log(w[6])
        np.testing.assert_allclose(lse_g, lse_w, rtol=TOL)
    # a window that holds fewer than k columns pads with (NEG_INF, ID_PAD)
    n_valid = int(((id_offset + np.arange(c) >= c_lo)
                   & (id_offset + np.arange(c) < hi)).sum())
    if k > n_valid:
        assert (g[0][:, n_valid:] == NEG_INF).all()
        assert (g[1][:, n_valid:] == ID_PAD).all()


@pytest.mark.parametrize("n,c,d,chunk,integer", [
    (7, 1000, 64, 512, False),
    (130, 3000, 63, 100, False),  # two gather buffers, d % 4 != 0
    (40, 1037, 33, 256, True),
    (5, 70, 8, 64, False),
])
def test_tgt_is_bitwise_the_swept_column(n, c, d, chunk, integer):
    """The plain threshold equals, bit for bit, the score the plain sweep
    computes for each row's target column (its own chunk product), so a
    target in the top-k carries exactly ``tgt`` and ``eq >= 1``."""
    x, y, t = _inputs(n + c, n, c, d, integer, 0, 0, c)
    t[1] = 3  # keep every target in range
    xt, yt, tt = map(torch.from_numpy, (x, y, t))
    y[t[:4]] = 2.0 * x[:4]  # plant a few targets at the top of their row
    yt = torch.from_numpy(y)
    vals, ids, gt, eq, tgt, _, _ = ref.eval_fused_ref(xt, yt, tt, 10,
                                                      chunk=chunk)
    pad = (-c) % chunk
    yp = torch.cat([yt, torch.zeros(pad, d)])
    for r in range(n):
        j = int(t[r]) // chunk
        swept = (xt @ yp[j * chunk:(j + 1) * chunk].T)[r, int(t[r]) % chunk]
        assert swept.view(torch.int32) == tgt[r].view(torch.int32), r
    assert (eq >= 1).all()
    hit = ids == tt[:, None].to(torch.int32)
    assert hit[:4].any(1).all()
    assert torch.equal(vals[hit], tgt.expand(10, -1).T[hit])
    assert torch.equal(ops.eval_tgt_gather(xt, yt, tt, block_c=chunk), tgt)


@pytest.mark.parametrize("integer", [True, False])
def test_eval_tgt_gather_ref_matches_jax(integer):
    x, y, t = _inputs(3, 20, 900, 16, integer, 5, 0, 10**6)
    got = ref.eval_tgt_gather_ref(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(t), chunk=128,
                                  id_offset=5).numpy()
    want = np.asarray(jax_ref.eval_tgt_gather_ref(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(t), chunk=128,
        id_offset=5))
    assert got[1] == 0.0  # target outside y's id range
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.abs(x @ y.T).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def test_ops_dispatch_cpu_takes_the_plain_version():
    x, y, t = _inputs(4, 6, 300, 16, True, 0, 1, 290)
    xt, yt, tt = map(torch.from_numpy, (x, y, t))
    before = (kernel.eval_fused.launches, kernel.eval_tgt_gather.launches)
    got = ops.eval_fused(xt, yt, tt, 5, block_c=64, c_lo=1, c_hi=290,
                         with_lse=True)
    want = ref.eval_fused_ref(xt, yt, tt, 5, chunk=64, c_lo=1, c_hi=290,
                              with_lse=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (kernel.eval_fused.launches,
            kernel.eval_tgt_gather.launches) == before


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(4, 8)
    y = torch.zeros(20, 8)
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernel.eval_fused(x, y, t, 3)
    with pytest.raises(ValueError):
        kernel.eval_tgt_gather(x, y, t)


def test_library_name_follows_the_shared_headers(tmp_path):
    """An edit to a ``csrc/*.cuh`` header changes the library path of
    every source beside it, so a stale library is never reused."""
    src = tmp_path / "k.cu"
    src.write_text('#include "tile.cuh"\n')
    header = tmp_path / "tile.cuh"
    header.write_text("// v1\n")
    first = _build._library_path(src)
    assert first == _build._library_path(src)
    header.write_text("// v2\n")
    second = _build._library_path(src)
    assert second != first and second.name.startswith("k-")
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build._library_path(src) != second
