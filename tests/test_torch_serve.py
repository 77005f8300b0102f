"""The port's serving path on the CPU: the serve step against the JAX
package's ``make_seqrec_mips_serve_step`` on converted parameters, and
the retrieval server's router, padding, async round-trip, degraded
prefix, backpressure and default-device behaviour (ported from
``tests/test_serve.py`` and ``tests/test_fault_tolerance.py``).

Serve-step values agree within ``1e-5·max|score|`` (the two forwards fold
f32 sums in another order); ids agree wherever neighbouring scores are
further apart than that, and exactly tied items (duplicated catalog rows)
come lower id first.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch import steps as jax_steps
from repro.models import sasrec as jax_sasrec
from repro_torch.configs import get_arch
from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
from repro_torch.launch import serve
from repro_torch.launch import steps
from repro_torch.launch.serve import (
    BucketRouter,
    RetrievalServer,
    ServerOverloadedError,
    pad_to_bucket,
    unpad,
)
from repro_torch.models.convert import sasrec_params_from_jax

BUCKETS = (4, 16)
TOP_K = 5


@pytest.fixture(scope="module")
def server():
    srv = RetrievalServer(
        "sasrec-sce", buckets=BUCKETS, top_k=TOP_K, queue_size=256,
        device="cpu",
    )
    yield srv
    srv.close()


def _hist(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.n_items, size=(n, cfg.max_len)).astype(np.int32)


def _mk_server(**kw):
    kw.setdefault("buckets", (4, 8))
    kw.setdefault("top_k", 5)
    return RetrievalServer("sasrec-sce", device="cpu", **kw)


# ---------------------------------------------------------------------------
# Serve step against the JAX package
# ---------------------------------------------------------------------------
def test_serve_step_matches_jax():
    jarch = jax_get_arch("sasrec-sce")
    cfg = jarch.make_smoke_config()
    params = jax.tree.map(
        np.array, jax_sasrec.init_params(jax.random.PRNGKey(7), cfg)
    )
    half = cfg.n_items // 2
    params["item_emb"][half:cfg.n_items] = params["item_emb"][:half]  # ties
    hist = _hist(cfg, 6, seed=1)
    hist[1, :10] = 0  # a front-padded history
    k = 7
    jstep = jax_steps.make_seqrec_mips_serve_step(jarch, cfg, None, top_k=k)
    jp = jax.tree.map(jnp.asarray, params)
    wv, wi = (np.asarray(a) for a in jstep(jp, jnp.asarray(hist)))

    tstep = steps.make_seqrec_mips_serve_step(
        get_arch("sasrec-sce").make_smoke_config(), top_k=k
    )
    tv, ti = tstep(sasrec_params_from_jax(params, device="cpu"),
                   torch.from_numpy(hist))
    gv, gi = tv.numpy(), ti.numpy()
    assert gi.dtype == np.int32 and gi.shape == wi.shape == (6, k)
    assert ((gi >= 1) & (gi < cfg.n_items)).all()

    # Dense scores (JAX side) give the gaps, the (k+1)-th included.
    h = np.asarray(jax_sasrec.forward(jp, cfg, jnp.asarray(hist)))[:, -1]
    y = params["item_emb"][: cfg.catalog_loss_size]
    s = h.astype(np.float64) @ y.T.astype(np.float64)
    s[:, 0] = -np.inf
    s[:, cfg.n_items:] = -np.inf
    dense = -np.sort(-s, axis=1)[:, : k + 1]
    tol = 1e-5 * np.abs(dense[:, 0]).max()
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol)
    prv = np.concatenate([np.full((6, 1), np.inf), dense[:, :k - 1]], 1)
    isolated = ((prv - dense[:, :k]) > tol) & \
        ((dense[:, :k] - dense[:, 1:]) > tol)
    np.testing.assert_array_equal(gi[isolated], wi[isolated])
    # Duplicated rows score identically in the port: lower id first.
    for r in range(6):
        for j in range(k - 1):
            if gv[r, j] == gv[r, j + 1]:
                assert gi[r, j] < gi[r, j + 1]
    dup = gi[(gi >= half)]
    assert dup.size, "tie construction failed to reach the top-k"


def test_data_batches_match_reference():
    from repro.data import Cursor as JCursor
    from repro.data import SeqDataConfig as JCfg
    from repro.data import SequenceDataset as JData

    kw = dict(n_items=500, seq_len=32, batch_size=6)
    got, cur = SequenceDataset(SeqDataConfig(**kw)).next_batch(Cursor(seed=3))
    want, jcur = JData(JCfg(**kw)).next_batch(JCursor(seed=3))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    assert (cur.seed, cur.step) == (jcur.seed, jcur.step)


# ---------------------------------------------------------------------------
# pad_to_bucket / unpad / BucketRouter
# ---------------------------------------------------------------------------
def test_pad_unpad_edge_cases():
    bucket = 4
    for n in (0, 1, bucket):  # empty, single, exactly-full
        x = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
        padded = pad_to_bucket(x, bucket)
        assert padded.shape == (bucket, 3) and padded.dtype == x.dtype
        np.testing.assert_array_equal(padded[:n], x)
        np.testing.assert_array_equal(padded[n:], 0)
        np.testing.assert_array_equal(unpad(padded, n), x)
    with pytest.raises(ValueError):
        pad_to_bucket(np.zeros((bucket + 1, 3), np.int32), bucket)
    with pytest.raises(ValueError):
        unpad(np.zeros((bucket, 3)), bucket + 1)


def test_pad_unpad_other_axis():
    x = np.ones((2, 3), np.float32)
    padded = pad_to_bucket(x, 5, axis=1)
    assert padded.shape == (2, 5)
    np.testing.assert_array_equal(unpad(padded, 3, axis=1), x)


def test_bucket_router_static_set():
    r = BucketRouter((16, 4, 4, 8))  # dedup + sort
    assert r.buckets == (4, 8, 16) and r.max_bucket == 16
    assert [r.bucket_for(n) for n in (1, 4, 5, 16)] == [4, 4, 8, 16]
    for bad in (0, -1, 17):
        with pytest.raises(ValueError):
            r.bucket_for(bad)
    with pytest.raises(ValueError):
        BucketRouter(())
    with pytest.raises(ValueError):
        BucketRouter((0, 4))


def test_bucket_router_plan_covers_any_arrival():
    r = BucketRouter(BUCKETS)
    assert r.plan(0) == []
    for n in range(0, 3 * max(BUCKETS) + 1):
        plan = r.plan(n)
        assert sum(c for c, _ in plan) == n
        for count, bucket in plan:
            assert bucket in r.buckets and 0 < count <= bucket


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------
def test_server_arbitrary_arrivals_zero_cache_misses(server):
    for n in (0, 1, 3, 4, 5, 16, 17, 33):
        hist = _hist(server.cfg, n, seed=n)
        vals, ids = server.score(hist)  # bulk path (plan → pad → run)
        assert vals.shape == (n, TOP_K) and ids.shape == (n, TOP_K)
        if n:
            assert (ids >= 1).all() and (ids < server.cfg.n_items).all()
            for r in [server.submit(h) for h in hist]:  # async burst
                res = r.result(timeout=60.0)
                assert res.ids.shape == (res.k,)
    assert server.cache_misses == 0
    assert server.compile_count == len(BUCKETS)
    table = server.health()["conformance"]
    assert server.ready and any(v["kernel"] == "mips_topk" and v["passed"]
                                for v in table)


def test_async_roundtrip_matches_bulk(server):
    hist = _hist(server.cfg, 5, seed=3)
    vals, ids = server.score(hist)
    reqs = [server.submit(h) for h in hist]
    for i, r in enumerate(reqs):
        res = r.result(timeout=60.0)
        assert not res.degraded and res.k == TOP_K
        np.testing.assert_array_equal(res.ids, ids[i])
        np.testing.assert_allclose(res.vals, vals[i], rtol=1e-6)
        assert r.latency_ms is not None and r.latency_ms >= 0


def test_server_takes_params_and_full_width_cfg():
    cfg = get_arch("sasrec-sce").make_smoke_config()
    from repro_torch.models import sasrec

    params = sasrec.init_params(cfg, seed=11, device="cpu")
    srv = RetrievalServer("sasrec-sce", cfg=cfg, buckets=(2,), top_k=3,
                          params=params, device="cpu")
    assert srv.cfg is cfg and srv.params["item_emb"].data_ptr() == \
        params["item_emb"].data_ptr()
    srv.close()


def test_submit_rejects_bad_shape_and_closed():
    srv = _mk_server(buckets=(2,), top_k=3)
    with pytest.raises(ValueError):
        srv.submit(np.zeros((3,), np.int32))  # wrong history length
    srv.close()
    with pytest.raises(ServerOverloadedError):
        srv.submit(np.zeros((srv.cfg.max_len,), np.int32))


def test_server_worker_kill_rejects_never_drops():
    srv = _mk_server(queue_size=16)
    orig_run = srv._run

    def boom(bucket, tokens):
        raise RuntimeError("injected worker kill")

    srv._run = boom
    reqs = [srv.submit(h) for h in _hist(srv.cfg, 6)]
    for r in reqs:
        with pytest.raises(ServerOverloadedError, match="not served"):
            r.result(timeout=60.0)
    assert srv.rejected >= 6
    srv._run = orig_run  # resubmit = retry
    res = srv.submit(_hist(srv.cfg, 1)[0]).result(timeout=60.0)
    assert res.ids.shape == (res.k,) and srv.cache_misses == 0
    srv.close()


def test_server_stalled_worker_returns_degraded_prefix():
    srv = _mk_server(top_k=6, degraded_top_k=2, queue_size=16)
    orig_run = srv._run

    def stalled(bucket, tokens):
        time.sleep(0.3)  # past the 50 ms deadline
        return orig_run(bucket, tokens)

    srv._run = stalled
    res = srv.submit(_hist(srv.cfg, 1)[0], deadline_s=0.05).result(60.0)
    assert res.degraded and res.k == 2 and res.ids.shape == (2,)
    assert srv.degraded_served == 1
    srv._run = orig_run
    full = srv.submit(_hist(srv.cfg, 1)[0]).result(timeout=60.0)
    assert not full.degraded
    np.testing.assert_array_equal(res.ids, full.ids[:2])  # exact prefix
    srv.close()


def test_server_backpressure_and_close_reject_explicitly():
    srv = _mk_server(buckets=(1,), queue_size=2)
    orig_run = srv._run
    gate = threading.Event()

    def gated(bucket, tokens):
        gate.wait(30.0)
        return orig_run(bucket, tokens)

    srv._run = gated
    in_flight = srv.submit(_hist(srv.cfg, 1)[0])
    deadline = time.monotonic() + 10.0
    while srv._queue and time.monotonic() < deadline:
        time.sleep(0.01)  # worker picks the first request up
    assert not srv._queue
    queued = [srv.submit(h) for h in _hist(srv.cfg, 2, seed=1)]
    with pytest.raises(ServerOverloadedError, match="queue full"):
        srv.submit(_hist(srv.cfg, 1)[0])
    assert srv.rejected == 1
    closer = threading.Thread(target=srv.close, daemon=True)
    closer.start()
    for q in queued:
        with pytest.raises(ServerOverloadedError, match="closed"):
            q.result(timeout=60.0)
    with pytest.raises(ServerOverloadedError):
        srv.submit(_hist(srv.cfg, 1)[0])
    gate.set()  # the in-flight batch still completes
    assert in_flight.result(timeout=60.0).ids.shape == (5,)
    closer.join(timeout=30.0)
    assert not closer.is_alive()


def test_server_default_device_needs_cuda(monkeypatch):
    """With no device given and no CUDA, the server raises rather than
    carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrievalServer("sasrec-sce", buckets=(2,))


def test_cli_serves_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--requests", "5", "--buckets", "2,4", "--device", "cpu",
    ])
    serve.main()
    out = capsys.readouterr().out
    assert "served 5 requests on cpu" in out and "cache_misses=0" in out


# ---------------------------------------------------------------------------
# The readiness gate (the kernel guard's mips_topk verdict)
# ---------------------------------------------------------------------------
def test_server_health_reports_guard_and_conformance(server):
    h = server.health()
    assert h["ready"] is True and h["readiness_error"] is None
    assert h["guard_policy"] == "warn"
    mine = [v for v in h["conformance"] if v["kernel"] == "mips_topk"]
    assert mine and mine[0]["passed"] and mine[0]["device"] == "cpu"
    assert mine[0]["n_pass"] == 3 and mine[0]["failures"] == []


def test_server_readiness_drill(monkeypatch):
    """A broken ``mips_topk`` on the CUDA route (``ops._device_kind``
    patched so it runs here): the server stays not ready, cold, and
    refuses async and bulk requests with ``ServerNotReadyError``; after the
    fix, ``refresh_readiness`` re-admits traffic."""
    from repro_torch.kernels import guard, ops
    from repro_torch.kernels import mips_topk as mips_mod

    def broken(*a, **k):
        raise RuntimeError("injected miscompile")

    guard.clear_verdicts("mips_topk")
    with monkeypatch.context() as m:
        m.setattr(ops, "_device_kind", lambda op, *t: "cuda")
        m.setattr(mips_mod, "mips_topk", broken)
        srv = _mk_server(queue_size=8)
        assert srv.ready is False and srv.compile_count == 0
        assert "mips_topk" in srv.readiness_error
        assert "injected miscompile" in srv.readiness_error
        hist = _hist(srv.cfg, 2)
        with pytest.raises(serve.ServerNotReadyError) as ei:
            srv.submit(hist[0])
        assert not isinstance(ei.value, ServerOverloadedError)
        with pytest.raises(serve.ServerNotReadyError):
            srv.score(hist)
        assert srv.rejected == 2
        h = srv.health()
        assert h["ready"] is False and h["readiness_error"]
        assert any(not v["passed"] for v in h["conformance"])
    guard.clear_verdicts("mips_topk")
    try:
        assert srv.refresh_readiness() is True
        assert srv.compile_count == 2 and srv.readiness_error is None
        vals, ids = srv.score(hist)
        assert ids.shape == (2, 5)
    finally:
        srv.close()


def test_server_deferred_readiness_and_policy_off(monkeypatch):
    from repro_torch.kernels import guard

    srv = _mk_server(defer_readiness=True)
    try:
        assert srv.ready is False and srv.compile_count == 0
        with pytest.raises(serve.ServerNotReadyError,
                           match="never run"):
            srv.submit(_hist(srv.cfg, 1)[0])
        assert srv.refresh_readiness() is True and srv.ready
    finally:
        srv.close()
    guard.set_policy("off")
    try:
        guard.clear_verdicts()
        srv = _mk_server()
        assert srv.ready and srv.health()["guard_policy"] == "off"
        assert srv.health()["conformance"] == []
        srv.close()
    finally:
        guard.set_policy(None)
