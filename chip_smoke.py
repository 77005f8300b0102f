#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``. Phases:

1. Device: needs ``torch.cuda.is_available()`` (else exits 2, printing no
   result); prints ``nvidia-smi``'s name and power limit.
2. Build: compiles every kernel of ``src/repro_torch/kernels/csrc/``
   (one ``nvcc`` per source, in parallel) into ``build/torch_kernels/``
   and prints the build seconds and the compiler's resource report.
3. Kernel against its plain version on the card: ``mips_topk`` at the
   serve shapes (n_q ∈ {8, 32, 512}, C = 173,520, d = 64, k = 10, window
   [1, 173,511)) and adversarial cases (integer ties, C tail, k > C, a
   starved ``valid``, an ``id_offset``, k = 256, d % 4 != 0, a catalog
   off a 16-byte boundary). Values agree within
   ``1e-5·max|score|`` (f32 fold order differs between the kernel and
   cuBLAS); ids agree exactly wherever neighbouring scores are further
   apart than that, and bit for bit on integer-valued inputs, where every
   fold order is exact. Times the kernel, the plain version and
   ``torch.matmul`` + ``torch.topk`` with a cold L2 cache.
4. The server at full width: ``RetrievalServer("sasrec-sce",
   cfg=make_config(), buckets=(8, 32, 512), top_k=10, device="cuda")``
   serves waves of async requests and one bulk ``score()`` of 512
   histories; the ids are held against a dense on-card oracle, the
   kernel's launch count must have moved, and ``cache_misses`` must be 0.
5. Prints the kernels' JSON line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result. ``--json PATH`` also writes every case, time and count to PATH.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12  # f32 outside the tensor cores

C_SERVE = 173_520  # sasrec-sce's shard-even catalog slice
N_ITEMS = 173_511
D = 64
K = 10
BUCKETS = (8, 32, 512)
NEG_INF = -1e30
ID_PAD = 2**31 - 1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel against its plain version
# ---------------------------------------------------------------------------
def dense_topk(scores, k):
    """Top-``k`` of a dense masked score matrix with the merge's tie rule
    (value desc, id asc) — a stable descending sort over id order."""
    import torch

    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    order = order[:, :k]
    return torch.gather(scores, 1, order), order.to(torch.int32)


def compare(got, want, want_next, tol, *, exact: bool):
    """Hold a kernel result against the plain one. ``want_next`` is the
    plain (k+1)-th value per row (or None when k = C). Returns the max
    |value| difference; raises on disagreement."""
    import torch

    gv, gi = got
    wv, wi = want
    check(gv.shape == wv.shape and gi.shape == wi.shape,
          f"shape {tuple(gv.shape)} vs {tuple(wv.shape)}")
    check(gi.dtype == torch.int32, f"ids dtype {gi.dtype}")
    err = (gv - wv).abs().max().item() if gv.numel() else 0.0
    if exact:
        check(torch.equal(gv, wv), f"values differ bitwise (max {err})")
        check(torch.equal(gi, wi), "ids differ on exact inputs")
        return err
    check(err <= tol, f"values differ by {err} > {tol}")
    # Ids must match where position j's score is isolated: further than
    # tol from its neighbours (the (k+1)-th included).
    nxt = wv[:, 1:]
    if want_next is not None:
        nxt = torch.cat([nxt, want_next[:, None]], dim=1)
    else:
        nxt = torch.cat([nxt, torch.full_like(wv[:, :1], NEG_INF)], dim=1)
    prv = torch.cat([torch.full_like(wv[:, :1], float("inf")), wv[:, :-1]],
                    dim=1)
    isolated = ((prv - wv) > tol) & ((wv - nxt) > tol)
    bad = isolated & (gi != wi)
    check(not bad.any().item(),
          f"{int(bad.sum())} isolated ids differ from the plain version")
    return err


def run_case(name, q, y, k, *, valid=None, id_offset=0, exact=False):
    """Kernel vs plain version on one input; returns a result dict."""
    import torch

    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.kernels.ref import mips_topk_ref

    got = mips_topk(q, y, k, valid=valid, id_offset=id_offset)
    torch.cuda.synchronize()
    c = y.shape[0]
    kk = min(k, c)
    want = mips_topk_ref(q, y, kk, valid=valid, id_offset=id_offset)
    want_next = None
    if kk < c:
        nv, _ = mips_topk_ref(q, y, kk + 1, valid=valid, id_offset=id_offset)
        want_next = nv[:, kk]
    scale = (q @ y.T).abs().max().item()
    tol = 1e-5 * scale
    err = compare(got, want, want_next, tol, exact=exact)
    n_pad = int((got[1] == ID_PAD).sum())
    print(f"  case {name}: n_q={q.shape[0]} C={c} d={q.shape[1]} k={kk} "
          f"id_offset={id_offset} max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'bitwise' if exact else 'gap-aware'} ID_PAD={n_pad} ok")
    return {"name": name, "n_q": q.shape[0], "C": c, "d": q.shape[1],
            "k": kk, "max_abs_err": err, "tol": tol, "exact": exact,
            "id_pad_slots": n_pad}


def time_ms(fn, reps, flush):
    """Mean device time of ``fn`` over ``reps`` runs, each after an L2
    flush (the serve step's catalog read comes from device memory). The
    flush (zeroing 1 GiB, about 0.3 ms of device time) is queued first,
    so ``fn``'s launches are queued while it runs and the events time the
    device work, not the host's enqueue."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound_ms(n_q, c, d, k):
    """Least time for the work: inputs read once (q, y, the bool valid
    mask), outputs written once, 2·n_q·C·d f32 FLOPs — the larger of the
    byte time and the FLOP time, and which one it is."""
    nbytes = 4 * (n_q * d + c * d) + c + 8 * n_q * k
    flops = 2 * n_q * c * d
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev):
    import torch

    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.kernels.ref import mips_topk_ref

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device=dev).to(torch.float32)

    ar = torch.arange(C_SERVE, device=dev)
    window = (ar >= 1) & (ar < N_ITEMS)
    y = randn(C_SERVE, D, scale=0.02)  # embed_init scale
    cases = []
    serve = {}
    for n_q in BUCKETS:
        q = randn(n_q, D)
        r = run_case(f"serve_b{n_q}", q, y, K, valid=window)
        cases.append(r)
        serve[n_q] = (q, r)

    # Adversarial cases (mirroring the reference's conformance canaries).
    qi, yi = randint(-2, 3, 32, D), randint(-2, 3, C_SERVE, D)
    cases.append(run_case("int_ties_serve", qi, yi, K, valid=window,
                          exact=True))
    cases.append(run_case("int_ties_k256", randint(-2, 3, 40, 128),
                          randint(-2, 3, 20_000, 128), 256, exact=True))
    cases.append(run_case("c_tail", randn(8, D), randn(1_037, D), K))
    cases.append(run_case("k_gt_c", randint(-3, 4, 5, D),
                          randint(-3, 4, 7, D), K, exact=True))
    starved = torch.zeros(500, dtype=torch.bool, device=dev)
    starved[torch.tensor([3, 77, 78, 200, 301, 499], device=dev)] = True
    cases.append(run_case("starved_valid", randint(-3, 4, 9, D),
                          randint(-3, 4, 500, D), K, valid=starved,
                          exact=True))
    cases.append(run_case(
        "id_offset", randn(16, D), randn(3_000, D), K,
        valid=torch.rand(3_000, generator=g, device=dev) > 0.3,
        id_offset=1_000,
    ))
    cases.append(run_case("k256_d256", randn(40, 256), randn(30_000, 256),
                          256))
    # d % 4 != 0, and a catalog 4 bytes off a 16-byte boundary: the
    # 4-byte tile loader (and, for odd d, the zeroed depth padding).
    cases.append(run_case("odd_d33_ties", randint(-2, 3, 37, 33),
                          randint(-2, 3, 1_100, 33), K,
                          valid=torch.arange(1_100, device=dev) >= 1,
                          id_offset=7, exact=True))
    cases.append(run_case("odd_d63", randn(12, 63), randn(2_000, 63), 20,
                          id_offset=3))
    y_off = randint(-2, 3, 700 * D + 1)[1:].view(700, D)
    check(y_off.data_ptr() % 16 != 0, "misaligned catalog is aligned")
    cases.append(run_case("misaligned_y", randint(-2, 3, 9, D), y_off, K,
                          exact=True))

    # Times at the serve shapes, cold L2 (the H100's is 50 MB).
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    timings = {}
    for n_q in BUCKETS:
        q, r = serve[n_q]

        def kernel():
            return mips_topk(q, y, K, valid=window)

        def plain():
            return mips_topk_ref(q, y, K, valid=window)

        def library():
            s = torch.where(window[None, :], torch.matmul(q, y.T), NEG_INF)
            return torch.topk(s, K)

        b, by = bound_ms(n_q, C_SERVE, D, K)
        timings[n_q] = {
            "ms": time_ms(kernel, 50, flush),
            "plain_ms": time_ms(plain, 3, flush),
            "library_ms": time_ms(library, 50, flush),
            "bound_ms": b, "bound_by": by,
            "max_abs_err": r["max_abs_err"],
        }
        t = timings[n_q]
        print(f"  time n_q={n_q}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({by})")
    return cases, timings


# ---------------------------------------------------------------------------
# The server at full width
# ---------------------------------------------------------------------------
def step_breakdown(server, hist, reps=20):
    """Where one serve step's time goes, per bucket: CUDA events between
    the step's phases (tokens to the card, SASRec forward, the mips_topk
    selection, results to the host) and the host clock around the whole
    step. The device timeline between two events includes any wait for
    the host to enqueue the next launch."""
    import torch

    from repro_torch.eval.streaming import streaming_topk
    from repro_torch.models import sasrec

    cfg, params, dev = server.cfg, server.params, server.device
    y = sasrec.loss_catalog(params, cfg)
    out = {}
    for bucket in server.router.buckets:
        tokens = hist[:bucket]
        sums = [0.0] * 4
        wall = 0.0
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                ev[0].record()
                tok = torch.from_numpy(tokens).to(dev)
                ev[1].record()
                x = sasrec.forward(params, cfg, tok)[:, -1].contiguous()
                ev[2].record()
                vals, ids = streaming_topk(x, y, server.top_k, c_lo=1,
                                           c_hi=cfg.n_items)
                ev[3].record()
                vals.cpu(), ids.cpu()
                ev[4].record()
            ev[4].synchronize()
            if rep:  # the first run is a warm-up
                wall += (time.perf_counter() - t0) * 1e3
                for i in range(4):
                    sums[i] += ev[i].elapsed_time(ev[i + 1])
        out[bucket] = dict(zip(
            ("h2d_ms", "forward_ms", "select_ms", "d2h_ms"),
            (s / reps for s in sums),
        ))
        out[bucket]["step_wall_ms"] = wall / reps
        b = out[bucket]
        print(f"  step b{bucket}: wall {b['step_wall_ms']:.3f} ms = "
              f"h2d {b['h2d_ms']:.3f} + forward {b['forward_ms']:.3f} + "
              f"mips_topk {b['select_ms']:.3f} + d2h {b['d2h_ms']:.3f} ms "
              f"(device events, mean of {reps})")
    return out


def server_phase(dev):
    import numpy as np
    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.launch.serve import RetrievalServer
    from repro_torch.models import sasrec

    cfg = make_config()
    check(cfg.catalog_loss_size == C_SERVE and cfg.n_items == N_ITEMS,
          "sasrec-sce catalog changed")
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=512,
    ))
    hist = data.next_batch(Cursor(seed=1))[0]["tokens"]

    mips_topk.launches = 0  # the main path starts here
    t0 = time.monotonic()
    server = RetrievalServer(
        "sasrec-sce", cfg=cfg, buckets=BUCKETS, top_k=K, queue_size=1024,
        seed=0, device="cuda",
    )
    setup_s = time.monotonic() - t0
    warm_launches = mips_topk.launches
    try:
        waves = (5, 19, 45)  # not bucket multiples
        reqs, ofs = [], 0
        t0 = time.monotonic()
        for n in waves:
            wave = [server.submit(h) for h in hist[ofs:ofs + n]]
            for r in wave:
                r.result(timeout=300.0)
            reqs += wave
            ofs += n
        async_s = time.monotonic() - t0
        t0 = time.monotonic()
        bulk_vals, bulk_ids = server.score(hist)
        bulk_s = time.monotonic() - t0
        health = server.health()
    finally:
        server.close()
    launches = mips_topk.launches  # the main path ends here
    breakdown = step_breakdown(server, hist)
    check(launches > warm_launches,
          f"serving launched mips_topk {launches - warm_launches} times")
    check(health["cache_misses"] == 0, f"cache_misses {health['cache_misses']}")
    check(health["compile_count"] == len(BUCKETS), "bucket warm-up count")
    results = [r.result() for r in reqs]
    check(all(not r.degraded and r.k == K for r in results),
          "an async request came back degraded")

    # Dense on-card oracle, same params and tie rule.
    with torch.inference_mode():
        tok = torch.from_numpy(hist).to(dev)
        hidden = sasrec.forward(server.params, cfg, tok)[:, -1]
        y = sasrec.loss_catalog(server.params, cfg)
        raw = hidden @ y.T
        gid = torch.arange(y.shape[0], device=dev)
        ok = (gid >= 1) & (gid < cfg.n_items)
        scale = raw[:, ok].abs().max().item()
        want_v, want_i = dense_topk(torch.where(ok[None, :], raw, NEG_INF),
                                    K + 1)
    # The oracle runs the forward at batch 512; async requests ran in other
    # bucket shapes, where cuBLAS may fold in another order: 1e-4·max|s|.
    tol = 1e-4 * scale
    async_v = torch.from_numpy(np.stack([r.vals for r in results])).to(dev)
    async_i = torch.from_numpy(np.stack([r.ids for r in results])).to(dev)
    n_async = len(results)
    errs = []
    for name, (gv, gi), rows in (
        ("async", (async_v, async_i), slice(0, n_async)),
        ("bulk", (torch.from_numpy(bulk_vals).to(dev),
                  torch.from_numpy(bulk_ids).to(dev)), slice(0, 512)),
    ):
        wv, wi = want_v[rows, :K], want_i[rows, :K]
        errs.append(compare((gv, gi), (wv, wi), want_v[rows, K], tol,
                            exact=False))
        check(bool(((gi >= 1) & (gi < cfg.n_items)).all()),
              f"{name}: an id outside [1, n_items) was served")
    lats = sorted(r.latency_ms for r in reqs)
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    out = {
        "config": {"n_items": cfg.n_items, "max_len": cfg.max_len,
                   "d_model": cfg.d_model, "n_layers": cfg.n_layers,
                   "n_heads": cfg.n_heads, "catalog_rows": C_SERVE},
        "setup_s": setup_s, "warm_launches": warm_launches,
        "launches": launches, "serve_launches": launches - warm_launches,
        "async_requests": n_async, "waves": list(waves),
        "async_s": async_s, "async_req_s": n_async / async_s,
        "p50_ms": p50, "p99_ms": p99, "bulk_histories": 512,
        "bulk_s": bulk_s, "bulk_req_s": 512 / bulk_s,
        "oracle_tol": tol, "oracle_max_abs_err": max(errs),
        "cache_misses": health["cache_misses"], "step_breakdown": breakdown,
    }
    print(f"  server: set-up {setup_s:.2f} s ({warm_launches} warm-up "
          f"launches); {n_async} async requests in waves {waves}: "
          f"{out['async_req_s']:.1f} req/s, p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms (n={n_async}, p99 = max); bulk 512 in "
          f"{bulk_s * 1e3:.3f} ms ({out['bulk_req_s']:.1f} req/s); "
          f"mips_topk launches {launches}; cache_misses 0; oracle max err "
          f"{max(errs):.3e} (tol {tol:.3e})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the detailed results to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    card = smi()
    print(f"[1/5] device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    t0 = time.monotonic()
    libs = _build.build_all()
    build_s = time.monotonic() - t0
    print(f"[2/5] build: {len(libs)} kernel libraries in {build_s:.2f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("[3/5] kernel against its plain version:")
    cases, timings = kernel_phase(dev)
    print("[4/5] server at full width:")
    server = server_phase(dev)

    t = timings[512]  # the serve_p99 bucket
    kernels = [{
        "name": "mips_topk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mips_topk.cu",
        "replaces": "src/repro/kernels/mips_topk.py:52",
        "launches": server["launches"],
        "max_abs_err": max(timings[b]["max_abs_err"] for b in BUCKETS),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": card, "build_s": build_s, "cases": cases,
            "timings": {str(b): v for b, v in timings.items()},
            "server": server, "kernels": kernels,
        }, indent=1))
    print("[5/5] summary")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
