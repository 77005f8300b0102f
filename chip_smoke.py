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
3. Serve kernel against its plain version on the card: ``mips_topk`` at
   the serve shapes (n_q ∈ {8, 32, 512}, C = 173,520, d = 64, k = 10,
   window [1, 173,511)) and adversarial cases (integer ties, C tail,
   k > C, a starved ``valid``, an ``id_offset``, k = 256, d % 4 != 0, a
   catalog off a 16-byte boundary). Values agree within
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
5. Train kernels against their plain versions on the card: ``mips_topk``
   at SCE training's two selections (320 bucket centres against 25,600
   positions at k = 320 under a mask with ≈ 25 % masked, and against the
   173,520 catalog rows at k = 256), a starved mask and k = 512; the
   three ``sce_gather`` kernels (forward, dX, dY) at the training shape
   (n_b = b_x = 320, b_y = 256, d = 64) on a real selection, with every
   bucket on the same candidates, with collisions and ``cand < 0``, and
   ragged (b_x = 23, b_y = 50, d = 33, softcap 30). Losses within
   ``1e-5·max|loss|``, gradients within ``rtol 2e-4``,
   ``atol 1e-5·max|grad|`` of autograd through the plain version, rows of
   dY no bucket selected exactly 0. Times each kernel, its plain version
   and ``torch.bmm`` on pre-gathered candidates (the nearest one-call
   yardstick; it computes the products alone) with a cold L2 cache.
6. The trainer at full width: ``train("sasrec-sce", cfg=make_config(),
   batch=128, steps=30, seed=0, device="cuda")``. Every loss finite, no
   step skipped, the mean loss of the last 5 steps below that of the
   first 5, ``mips_topk`` launched exactly 2 (once at k = 320, once at
   k = 256) and each ``sce_gather`` kernel exactly once per step. Prints
   the median step, the step's breakdown from CUDA events that the
   trainer's own steps record through its ``mark`` hook, and the run's
   peak device memory.
7. Prints the kernels' JSON line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``. ``mips_topk`` has
   three entries: all its main-path launches timed at serving's largest
   bucket, and its training selections (k = 320 over the positions,
   k = 256 over the catalog), each with the trainer's launches at that k.

Any failed check raises, so the script exits non-zero and prints no
result. ``--json PATH`` also writes every case, time and count to PATH.
"""
from __future__ import annotations

import argparse
import json
import math
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


def roofline_ms(nbytes, flops):
    """The larger of the byte time and the f32 FLOP time at the card's
    peaks, and which one it is."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_ms(n_q, c, d, k, *, valid=True):
    """Least time for the work: inputs read once (q, y, the bool valid
    mask when there is one), outputs written once, 2·n_q·C·d f32 FLOPs."""
    nbytes = 4 * (n_q * d + c * d) + (c if valid else 0) + 8 * n_q * k
    return roofline_ms(nbytes, 2 * n_q * c * d)


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


# ---------------------------------------------------------------------------
# Train kernels against their plain versions
# ---------------------------------------------------------------------------
N_POS = 128 * 200  # train_paper: batch 128 × L 200 positions
N_B, B_X, B_Y = 320, 320, 256  # SCEConfig.from_alpha_beta(25,600, 173,511)


def gather_case(name, x_b, y, idx, tgt, cand, pos, cap=None):
    """The three sce_gather kernels against autograd through the plain
    version on one input, for a random upstream cotangent. Returns the
    case's max errors; raises on disagreement."""
    import torch

    from repro_torch.kernels import ops, ref

    g = torch.rand(pos.shape, device=pos.device,
                   generator=torch.Generator(device=pos.device).manual_seed(5))
    got_l = [t.clone().requires_grad_(True) for t in (x_b, y, pos)]
    loss = ops.sce_gather_loss(got_l[0], got_l[1], idx, tgt, cand, got_l[2],
                               logit_softcap=cap)
    got = [loss.detach()] + list(torch.autograd.grad((loss * g).sum(), got_l))
    want_l = [t.clone().requires_grad_(True) for t in (x_b, y, pos)]
    wloss = ref.sce_gather_loss_ref(want_l[0], want_l[1], idx, tgt, cand,
                                    want_l[2], cap)
    want = [wloss.detach()] + list(torch.autograd.grad((wloss * g).sum(),
                                                       want_l))
    torch.cuda.synchronize()
    errs = {}
    for what, a, b, rtol in zip(("loss", "dx", "dy", "dpos"), got, want,
                                (0.0, 2e-4, 2e-4, 2e-4)):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{name}: {what} shape or finiteness")
        err = (a - b).abs()
        tol = 1e-5 * b.abs().max().item()
        check(bool((err <= tol + rtol * b.abs()).all()),
              f"{name}: {what} differs by {err.max().item():.3e} "
              f"(tol {tol:.3e} + {rtol}·|want|)")
        errs[what] = err.max().item()
    touched = torch.zeros(y.shape[0], dtype=torch.bool, device=y.device)
    touched[idx.long().reshape(-1)] = True
    check(bool((got[2][~touched] == 0).all()),
          f"{name}: a dY row no bucket selected is not exactly 0")
    n_b, b_x, d = x_b.shape
    print(f"  case {name}: n_b={n_b} b_x={b_x} b_y={idx.shape[1]} d={d} "
          f"C={y.shape[0]} cap={cap} max err loss {errs['loss']:.3e} dX "
          f"{errs['dx']:.3e} dY {errs['dy']:.3e} d_pos {errs['dpos']:.3e}; "
          f"{int((~touched).sum())} untouched dY rows exactly 0 ok")
    return {"name": name, "n_b": n_b, "b_x": b_x, "b_y": idx.shape[1],
            "d": d, "C": y.shape[0], "cap": cap, "max_abs_err": errs}


def gather_bounds(x_b, y, idx):
    """Least times of the three kernels on these inputs: each reads x_b,
    the distinct catalog rows it gathers, the ids and its per-row inputs
    once and writes its outputs once; the forward does 2·n_b·b_x·b_y·d
    f32 FLOPs, dX and dY twice that (the logits again, then a product of
    the same size)."""
    import torch

    n_b, b_x, d = x_b.shape
    b_y = idx.shape[1]
    rows = int(torch.unique(idx).numel())
    common = 4 * (n_b * b_x * d + rows * d + 2 * n_b * b_y)
    flops = 2 * n_b * b_x * b_y * d
    return {
        "sce_gather_fwd": roofline_ms(common + 4 * 4 * n_b * b_x, flops),
        "sce_gather_dx": roofline_ms(
            common + 4 * 3 * n_b * b_x + 4 * n_b * b_x * d, 2 * flops),
        "sce_gather_dy": roofline_ms(
            common + 4 * 3 * n_b * b_x + 4 * y.shape[0] * d, 2 * flops),
    }


def train_kernel_phase(dev):
    import torch

    from repro_torch.core import sce
    from repro_torch.kernels import ref, sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.kernels.ref import mips_topk_ref

    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device=dev).to(torch.float32)

    # The selections of one training step at the paper's shape.
    x = randn(N_POS, D)  # hidden states
    y = randn(C_SERVE, D, scale=0.125)  # catalog rows
    valid = torch.rand(N_POS, generator=g, device=dev) > 0.25
    targets = torch.randint(1, N_ITEMS, (N_POS,), generator=g, device=dev,
                            dtype=torch.int32)
    cfg = sce.SCEConfig.from_alpha_beta(N_POS, N_ITEMS, use_kernel=True)
    check((cfg.n_buckets, cfg.bucket_size_x, cfg.bucket_size_y)
          == (N_B, B_X, B_Y), "the paper's SCE shape changed")
    b = sce.make_bucket_centers(x, N_B, use_mix=True, valid_mask=valid,
                                generator=g)
    cases = [
        run_case("train_positions_k320", b, x, B_X, valid=valid),
        run_case("train_catalog_k256", b, y, B_Y),
    ]
    starved = torch.zeros(N_POS, dtype=torch.bool, device=dev)
    starved[torch.randperm(N_POS, generator=g, device=dev)[:B_X // 3]] = True
    cases.append(run_case("starved_k320", randint(-2, 3, 40, D),
                          randint(-2, 3, N_POS, D), B_X, valid=starved,
                          exact=True))
    cases.append(run_case("k512_ties", randint(-2, 3, 64, D),
                          randint(-2, 3, 20_000, D), 512, exact=True))

    # The in-bucket loss on that real selection.
    idx_x, idx_y = sce.select_buckets(b, x, y, cfg, valid_mask=valid)
    ix = idx_x.long()
    x_b = x[ix].contiguous()
    tgt_b = targets[ix].to(torch.int32)
    pos = torch.einsum("nxd,nxd->nx", x_b, y[tgt_b.long()]).contiguous()
    gcases = [gather_case("train_shape", x_b, y, idx_y, tgt_b, idx_y, pos)]
    same = idx_y[:1].expand(N_B, -1).contiguous()
    gcases.append(gather_case("same_candidates", x_b, y, same, tgt_b, same,
                              pos))
    rows = torch.stack([torch.randperm(5_000, generator=g, device=dev)[:128]
                        for _ in range(64)]).to(torch.int32)
    tg = torch.randint(0, 5_000, (64, 100), generator=g, device=dev,
                       dtype=torch.int32)
    cand = rows.clone()
    cand[:, 0] = tg[:, 0]
    cand[:, -1] = -1
    gcases.append(gather_case("collisions_cand_neg", randn(64, 100, D),
                              randn(5_000, D), rows, tg, cand,
                              randn(64, 100)))
    rows = torch.stack([torch.randperm(300, generator=g, device=dev)[:50]
                        for _ in range(7)]).to(torch.int32)
    gcases.append(gather_case(
        "ragged_d33_cap30", randn(7, 23, 33, scale=8.0), randn(300, 33),
        rows, torch.randint(0, 300, (7, 23), generator=g, device=dev,
                            dtype=torch.int32), rows,
        30.0 * torch.tanh(randn(7, 23)), cap=30.0))

    # Times at the training shape, cold L2.
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    timings = {}
    for name, q, cat, k, vm in (("positions_k320", b, x, B_X, valid),
                                ("catalog_k256", b, y, B_Y, None)):
        def kernel():
            return mips_topk(q, cat, k, valid=vm)

        def plain():
            return mips_topk_ref(q, cat, k, valid=vm)

        def library():
            s_ = torch.matmul(q, cat.T)
            if vm is not None:
                s_ = torch.where(vm[None, :], s_, NEG_INF)
            return torch.topk(s_, k)

        bd, by = bound_ms(q.shape[0], cat.shape[0], D, k,
                          valid=vm is not None)
        timings[name] = {"ms": time_ms(kernel, 20, flush),
                         "plain_ms": time_ms(plain, 2, flush),
                         "library_ms": time_ms(library, 20, flush),
                         "bound_ms": bd, "bound_by": by}

    g_up = torch.rand(pos.shape, generator=g, device=dev)
    _, lse = sce_prefetch.sce_gather_fwd(x_b, y, idx_y, tgt_b, idx_y, pos)
    y_b = y[idx_y.long()]
    probs = torch.rand(N_B, B_X, B_Y, generator=g, device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (x_b, y)]
    out = (ref.sce_gather_loss_ref(leaves[0], leaves[1], idx_y, tgt_b, idx_y,
                                   pos) * g_up).sum()
    args = (x_b, y, idx_y, tgt_b, idx_y)
    runs = {
        "sce_gather_fwd": (
            lambda: sce_prefetch.sce_gather_fwd(*args, pos),
            lambda: ref.sce_gather_loss_ref(*args, pos),
            lambda: torch.bmm(x_b, y_b.transpose(1, 2))),
        "sce_gather_dx": (
            lambda: sce_prefetch.sce_gather_dx(*args, lse, g_up),
            lambda: torch.autograd.grad(out, leaves[0], retain_graph=True),
            lambda: torch.bmm(probs, y_b)),
        "sce_gather_dy": (
            lambda: sce_prefetch.sce_gather_dy(*args, lse, g_up),
            lambda: torch.autograd.grad(out, leaves[1], retain_graph=True),
            lambda: torch.bmm(probs.transpose(1, 2), x_b)),
    }
    bounds = gather_bounds(x_b, y, idx_y)
    with torch.no_grad():
        for name, (kern, plain, lib) in runs.items():
            timings[name] = {"ms": time_ms(kern, 20, flush),
                             "plain_ms": time_ms(plain, 5, flush),
                             "library_ms": time_ms(lib, 20, flush),
                             "bound_ms": bounds[name][0],
                             "bound_by": bounds[name][1]}
    for name, t in timings.items():
        print(f"  time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return cases, gcases, timings


# ---------------------------------------------------------------------------
# The trainer at full width
# ---------------------------------------------------------------------------
TRAIN_STEPS = 30


PHASES = ("h2d", "forward", "select", "loss_forward", "backward",
          "optimizer")


class StepMarks:
    """The ``mark`` hook of ``launch/train.py::train``: a CUDA event where
    each phase of each step ends (``"start"`` opens a step), read after
    the run. The device timeline between two events includes any wait for
    the host to enqueue the next launch."""

    def __init__(self):
        self.steps = []

    def __call__(self, name):
        import torch

        if name == "start":
            self.steps.append([])
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1].append((name, ev))

    def breakdown(self, skip=1):
        """Mean ms of each phase over the steps after the first ``skip``."""
        sums = dict.fromkeys(PHASES, 0.0)
        for marks in self.steps[skip:]:
            names = [n for n, _ in marks]
            check(names == ["start", *PHASES], f"phase marks {names}")
            for (_, a), (name, b) in zip(marks, marks[1:]):
                sums[name] += a.elapsed_time(b)
        n = len(self.steps) - skip
        return {f"{k}_ms": v / n for k, v in sums.items()}


def train_phase(dev):
    import statistics

    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.core import sce
    from repro_torch.kernels import sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.launch.train import train

    cfg = make_config()
    counters = (mips_topk, sce_prefetch.sce_gather_fwd,
                sce_prefetch.sce_gather_dx, sce_prefetch.sce_gather_dy)
    marks = StepMarks()
    torch.cuda.synchronize()
    live_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters:  # the main path starts here
        fn.launches = 0
    mips_topk.launches_by_k.clear()
    t0 = time.monotonic()
    out = train("sasrec-sce", cfg=cfg, batch=N_POS // cfg.max_len,
                steps=TRAIN_STEPS, seed=0, log_every=10, device=dev,
                mark=marks)
    wall_s = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in counters}  # ... ends here
    by_k = dict(mips_topk.launches_by_k)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = out["losses"]
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} steps ran")
    check(all(math.isfinite(v) for v in losses), "a training loss is not "
          "finite")
    check(out["skipped_steps"] == 0, f"{out['skipped_steps']} steps skipped")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"mean loss of the last 5 steps {last:.5f} is not "
          f"below the first 5's {first:.5f}")
    check(launches["mips_topk"] == 2 * TRAIN_STEPS
          and by_k == {B_X: TRAIN_STEPS, B_Y: TRAIN_STEPS},
          f"mips_topk launched {launches['mips_topk']} times ({by_k} by k) "
          f"in {TRAIN_STEPS} steps")
    for name in ("sce_gather_fwd", "sce_gather_dx", "sce_gather_dy"):
        check(launches[name] == TRAIN_STEPS,
              f"{name} launched {launches[name]} times in {TRAIN_STEPS} "
              f"steps")
    median_ms = statistics.median(out["step_s"][1:]) * 1e3
    print(f"  trainer: {TRAIN_STEPS} steps of batch {N_POS // cfg.max_len} "
          f"× L {cfg.max_len}, C {cfg.catalog_loss_size}, in {wall_s:.2f} s; "
          f"loss {losses[0]:.4f} → {losses[-1]:.4f} (mean of first 5 "
          f"{first:.4f}, last 5 {last:.4f}); median step {median_ms:.3f} ms "
          f"(host clock, steps 2–{TRAIN_STEPS}); launches {launches}, "
          f"mips_topk by k {by_k}")
    bd = marks.breakdown()
    print("  step breakdown: " + " + ".join(
        f"{p} {bd[p + '_ms']:.3f}" for p in PHASES)
        + f" = {sum(bd.values()):.3f} ms (device events of the trainer's "
        f"own steps, mean of steps 2–{TRAIN_STEPS})")
    sce_cfg = sce.SCEConfig.from_alpha_beta(N_POS, cfg.n_items)
    mem = {
        "peak_bytes": peak, "live_bytes_before": live_bytes,
        "sce_fused_peak_bytes": 4 * sce.sce_peak_elements(
            sce_cfg, N_POS, cfg.catalog_loss_size, cfg.d_model,
            fused=True)["total"],
        "sce_plain_peak_bytes": 4 * sce.sce_peak_elements(
            sce_cfg, N_POS, cfg.catalog_loss_size, cfg.d_model)["total"],
        "full_ce_logit_bytes": sce.full_ce_memory_bytes(
            N_POS, cfg.catalog_loss_size),
    }
    print(f"  peak device memory of the run: {peak / 2**20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated; params, AdamW state and "
          f"activations included; {live_bytes / 2**20:.1f} MiB were live "
          f"before it); SCE loss side, fused model "
          f"{mem['sce_fused_peak_bytes'] / 2**20:.2f} MiB, plain path "
          f"{mem['sce_plain_peak_bytes'] / 2**20:.1f} MiB; full CE logits "
          f"N·C·4 B = {mem['full_ce_logit_bytes'] / 1e9:.2f} GB")
    return {"losses": losses, "step_s": out["step_s"], "wall_s": wall_s,
            "median_step_ms": median_ms, "launches": launches,
            "mips_topk_launches_by_k": by_k, "breakdown": bd, "memory": mem}


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
    print(f"[1/7] device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    t0 = time.monotonic()
    libs = _build.build_all()
    build_s = time.monotonic() - t0
    print(f"[2/7] build: {len(libs)} kernel libraries in {build_s:.2f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("[3/7] serve kernel against its plain version:")
    cases, timings = kernel_phase(dev)
    print("[4/7] server at full width:")
    server = server_phase(dev)
    print("[5/7] train kernels against their plain versions:")
    tcases, gcases, ttimes = train_kernel_phase(dev)
    print("[6/7] trainer at full width:")
    trainer = train_phase(dev)

    t = timings[512]  # the serve_p99 bucket
    mips = {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mips_topk.cu",
            "replaces": "src/repro/kernels/mips_topk.py:52"}
    kernels = [{
        "name": "mips_topk",
        **mips,
        # serving's launches and training's, each path counted from 0
        "launches": server["launches"] + trainer["launches"]["mips_topk"],
        "max_abs_err": max([timings[b]["max_abs_err"] for b in BUCKETS]
                           + [c["max_abs_err"] for c in tcases]),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]
    # The same kernel at training's two selections, with the launches the
    # trainer made at that k.
    for name, k in (("positions_k320", B_X), ("catalog_k256", B_Y)):
        tt = ttimes[name]
        kernels.append({
            "name": f"mips_topk_train_{name}",
            **mips,
            "launches": trainer["mips_topk_launches_by_k"][k],
            "max_abs_err": next(c["max_abs_err"] for c in tcases
                                if c["name"] == f"train_{name}"),
            "ms": tt["ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"],
            "bound_by": tt["bound_by"],
            "library_ms": tt["library_ms"],
        })
    for name, what, line in (("sce_gather_fwd", "loss", 79),
                             ("sce_gather_dx", "dx", 152),
                             ("sce_gather_dy", "dy", 203)):
        tt = ttimes[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sce_gather.cu",
            "replaces": f"src/repro/kernels/sce_prefetch.py:{line}",
            "launches": trainer["launches"][name],
            "max_abs_err": max(c["max_abs_err"][what] for c in gcases),
            "ms": tt["ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"],
            "bound_by": tt["bound_by"],
            "library_ms": tt["library_ms"],
        })
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "card": card, "build_s": build_s, "cases": cases,
            "timings": {str(b): v for b, v in timings.items()},
            "server": server, "train_cases": tcases, "gather_cases": gcases,
            "train_timings": ttimes, "trainer": trainer, "kernels": kernels,
        }, indent=1))
    print("[7/7] summary")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
