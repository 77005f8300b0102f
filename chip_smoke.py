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
3. The kernel guard: ``run_conformance(refresh=True)`` on the card, the
   12 canaries of the 7 kernel groups (each kernel against its plain
   version, the two bitwise checks kernel against kernel), with the
   verdict table and its wall time. Any failure fails the run. The
   canaries are the one path that runs the ``sce_bucket`` and two-pass
   eval kernels (PERF.md rows 6, 7, 10, 11): their launches are counted
   from 0 around this phase. The verdicts stay memoized, so the later
   phases' dispatches consult them without running canaries.
4. Serve kernel against its plain version on the card: ``mips_topk`` at
   the serve shapes (n_q ∈ {8, 32, 512}, C = 173,520, d = 64, k = 10,
   window [1, 173,511)) and adversarial cases (integer ties, C tail,
   k > C, a starved ``valid``, an ``id_offset``, k = 256, d % 4 != 0, a
   catalog off a 16-byte boundary). Values agree within
   ``1e-5·max|score|`` (f32 fold order differs between the kernel and
   cuBLAS); ids agree exactly wherever neighbouring scores are further
   apart than that, and bit for bit on integer-valued inputs, where every
   fold order is exact. Times the kernel, the plain version and
   ``torch.matmul`` + ``torch.topk`` with a cold L2 cache.
5. The server at full width: ``RetrievalServer("sasrec-sce",
   cfg=make_config(), buckets=(8, 32, 512), top_k=10, device="cuda")``
   serves waves of async requests and one bulk ``score()`` of 512
   histories; the ids are held against a dense on-card oracle, the
   kernel's launch count must have moved, and ``cache_misses`` must be 0.
6. Train kernels against their plain versions on the card: ``mips_topk``
   at SCE training's two selections (320 bucket centres against 25,600
   positions at k = 320 under a mask with ≈ 25 % masked, and against the
   173,520 catalog rows at k = 256), a starved mask and k = 512, and the
   ``k > 32`` chain's adversarial inputs at those shapes (integer valued,
   bit for bit): every row's best columns in one residue of the
   threshold pass's tiles, all-equal scores, and a collect buffer of k
   entries that sends every row to the split sweep — each with its
   per-row collect counts. Times the chain's steps (threshold, τ,
   collect, select, the finishing sweep) at both selections, each
   kernel's device time from ``torch.profiler`` with a cold L2. The
   three ``sce_gather`` kernels (forward, dX, dY) at the training shape
   (n_b = b_x = 320, b_y = 256, d = 64) on a real selection, with every
   bucket on the same candidates, with collisions and ``cand < 0``, and
   ragged (b_x = 23, b_y = 50, d = 33, softcap 30). Losses within
   ``1e-5·max|loss|``, gradients within ``rtol 2e-4``,
   ``atol 1e-5·max|grad|`` of autograd through the plain version, rows of
   dY no bucket selected exactly 0. Times each kernel, its plain version
   and ``torch.bmm`` on pre-gathered candidates (the nearest one-call
   yardstick; it computes one product alone) with a cold L2 cache, and
   dX and dY composed in PyTorch on pre-gathered candidates (the logits
   ``bmm``, ``exp(l − lse)·g`` on the unmasked ones, the second ``bmm``;
   dY then ``index_add_`` into ``(C, d)``). The forward's bound is its
   f32 FMAs and bytes; dX and dY (3xTF32 on the tensor cores) are bound
   as ``linear_ce``'s kernels (phase 13): three TF32 passes, an exp per
   unmasked pair at the SFUs' rate, and the bytes, with the f32 FMA
   bound beside it. The wrapper's copy of dX / dY's launch plan must
   equal the library's at every d ≤ 256.
   The three ``sce_gather_plse`` launches (the partial LSE of distributed
   SCE: forward, dX, dY) the same way, on the same selection as the
   trainer's (1, 1) mesh sees it (every candidate owned), on shard 0 of a
   4-way catalog split of it (43,380 rows, ≈ 75 % of ``cand = −1``), with
   buckets that own no candidate and collisions, with softcap 30, and
   ragged; rows with no unmasked candidate must be exactly −1e30 with
   exactly 0 in dX. Timed on the (1, 1) and the shard inputs against the
   plain version and ``torch.baddbmm`` (the mask as its additive input) +
   ``torch.logsumexp`` on pre-gathered rows.
7. The trainer at full width, ``sce_mode="gspmd"`` (``core/sce.py``):
   ``train("sasrec-sce", cfg=make_config(), batch=128, steps=30, seed=0,
   sce_mode="gspmd", eval_every=10, eval_users=128, device="cuda")``.
   Every loss finite, no step skipped, the mean loss of the last 5 steps
   below that of the first 5, ``mips_topk`` launched exactly 2 (once at
   k = 320, once at k = 256) and each ``sce_gather`` kernel exactly once
   per step, ``sce_gather_plse`` never; three ``[eval]`` lines, each eval
   kernel launched once per evaluation. Prints the median step (its
   evaluations excluded: the trainer takes a step's time before its
   evaluation), the step's breakdown from CUDA events that the trainer's
   own steps record through its ``mark`` hook, and the run's peak device
   memory.
8. The same with the trainer's default ``sce_mode="exact"``: distributed
   SCE (``core/distributed_sce.py``) on the (1, 1) host mesh, each
   ``sce_gather_plse`` launch once per step and ``sce_gather`` never;
   the same checks and prints. It runs with ``guard_policy="strict"``
   after the ``mips_topk``, ``sce_gather`` and ``eval_fused`` verdicts
   are dropped: their canaries run at the first dispatch inside the
   trainer and must pass (their launches are taken out of the counts);
   every step's sentinels are zero, the loss cap is ``inf`` for 8 steps
   and finite from the 9th.
9. The same trainer with the guard ``off`` (no verdicts, no sentinels):
   the guard's cost per step, in the same call.
10. One full-width batch through the three SCE modes on one injected Ω:
   ``exact`` and ``union`` (on one card both select what ``gspmd``
   selects) against ``gspmd``, the loss within ``1e-5·|loss|``, the
   gradients of x and y within ``1e-5·max|g|`` plus ``2e-4·|g|``.
11. Eval kernels against their plain versions on the card: ``eval_fused``
   at B = 128 and 256 against the whole catalog (C = 173,520, k = 10,
   window [1, 173,511)), with the LSE on (cap none and 30), on
   integer-valued inputs, a ragged C with an ``id_offset``, and k above
   the valid columns; ``eval_tgt_gather`` with each. Integer inputs:
   ids, vals, ``gt``, ``eq`` and ``tgt`` equal bit for bit. Floats: vals
   within ``1e-5·max|score|``, ids equal where consecutive scores are
   more than ``1e-4·max|score|`` apart, ranks inside the band of a dense
   f64 oracle (other scores within ``1e-5·max|score|`` of the target
   may fall on either side), ``tgt`` within ``1e-5·max|score|``. The LSE
   ``m + log s`` within 1e-5 relative. Every input: a target in the
   kernel's top-k carries exactly ``tgt``, and ``eq ≥ 1`` on every row
   whose target is valid. Times each kernel, its plain version and one
   PyTorch computation of the same function with a cold L2 cache.
12. The evaluation at full width: ``evaluate_streaming`` over 8 held-out
   batches of 256 users (``eval_batch`` of ``Cursor(0, step)``, steps
   0–7) on random weights from seed 0, folded into one
   ``MetricAccumulator``; then the dense on-card oracle
   (``core/metrics.py``). Streamed and dense ranks inside the f64 band,
   HR/NDCG/COV@{1,5,10} side by side (HR and NDCG may differ by the
   share of rows whose rank the band leaves open), the eval kernels'
   launch counts, and the streaming evaluation's peak device memory
   against the dense ``B·C·4 B``.
13. Full-CE kernels against their plain versions on the card: the six
   launches of ``csrc/linear_ce.cu`` — ``linear_ce_fwd`` / ``_dx`` /
   ``_dw`` (the positive plucked in the sweep, softcap in the tile) and
   ``fused_lse_fwd`` / ``_dx`` / ``_dy`` (no pluck, no cap) — at the
   trainer's shape (x 25,600 × 64, w 173,520 × 64, whose last tile is
   ragged), with cap 30 past its knee, half the targets on one row and
   every third cotangent 0, and on integer-valued inputs (d = 33; d = 200
   with cap 30 and repeated targets). Values within ``1e-5·max|want|``,
   gradients within ``1e-5·max|grad|`` plus ``2e-4·|grad|`` of the plain
   versions (``linear_ce_loss_ref``, ``fused_lse_ref``,
   ``linear_ce_dx_ref``, ``linear_ce_dw_ref``), dX exactly 0 on rows with
   a zero cotangent. All six kernels (3xTF32 on the tensor cores) take
   the planes of ``linear_ce_split``, which must equal the plain split
   (``ref.tf32x3_planes_ref``) bit for bit on every input. Times each
   kernel, the split, their plain versions and one PyTorch call
   (``logsumexp(x @ wᵀ)``, ``softmax(x @ wᵀ) @ w``,
   ``softmax(x @ wᵀ)ᵀ @ x``, all f32; none for the split) with a cold L2
   cache. A kernel's bound is the largest of three TF32 passes at 495
   TFLOP/s, the N·C exps at the SFUs' rate (16 a clock per SM at
   ``nvidia-smi``'s top SM clock) and the bytes, its basis named and the
   f32 FMA bound printed beside it. The wrapper's copies of the forward's
   and the backward's launch plans (the guard's ``smem_budget``) must
   equal the library's at every d ≤ 256.
14. The trainer with the competitor losses at full width:
   ``make_seqrec_train_step`` with ``train_loss`` set by
   ``dataclasses.replace`` — ``ce_fused_linear`` and ``ce_fused`` for 20
   steps each (every loss finite, no step skipped, the mean of the last 5
   losses below the first 5's, each of the family's three kernels and the
   split launched once per step), then every other registry name at its
   ``make_loss`` defaults for 3 steps (``ce`` holds the dense
   ``(N, C)`` logits and runs at batch 64: at 128 they and their
   gradients do not fit an H100 80GB). Prints one table of each loss's
   median step and peak device memory beside SCE's from phases 7–8 and
   ``loss_peak_elements``.
15. The guard's kernels against their plain versions on the card:
   ``sce_bucket`` forward, dX, dY and the partial LSE at n_b 320, b_x
   320, b_y 256, d 64 with ``y_b`` gathered from the catalog (a collision
   and a padding slot per bucket), without and with cap 30 — losses and
   gradients within ``1e-5·max|want|`` plus ``2e-4·|want|``, masked dY
   rows exactly 0, two dY launches equal bit for bit; ``eval_tgt_scores``
   then ``eval_topk`` at B 256 and 128 against the whole catalog (k 10,
   window [1, 173,511)) and on shard 1 of 4 with its ``id_offset`` —
   values within ``1e-5·max|score|``, isolated ids equal, ``gt``/``eq``
   inside a dense f64 band, ``eq ≥ 1`` on every valid target (the
   threshold is bit for bit the swept column). Times each kernel, its
   plain version and one PyTorch call with a cold L2 (``sce_bucket``'s dX
   and dY bound in 3xTF32 as in phase 6).
16. Drills: the trainer at full width with ``chaos_nan_at=5`` must raise
   ``RuntimeError`` at step 7 after three ``[guard]`` strike lines naming
   ``sce_bucket_nonfinite``; a monkeypatched broken ``mips_topk`` must
   make its CUDA dispatch raise ``KernelConformanceError`` under ``warn``
   and keep a fresh server not ready (then the real kernel is restored
   and its verdict passes again).
17. Prints the kernels' JSON line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``. ``mips_topk`` has
   three entries: all its main-path launches timed at serving's largest
   bucket, and its training selections (k = 320 over the positions,
   k = 256 over the catalog), each with both trainers' launches at that
   k. ``eval_fused`` and ``eval_tgt_gather`` have two each: the
   evaluation phase's B = 256 and the trainers' B = 128. The three
   ``sce_gather_plse`` launches carry phase 8's launches and phase 6's
   times on the (1, 1) input. The six full-CE kernels and the split carry
   phase 14's launches and phase 13's times at the trainer's shape. The four
   ``sce_bucket`` launches and ``eval_topk`` / ``eval_tgt_scores`` carry
   phase 3's launches (the canaries') and phase 15's times (the eval ones
   at B = 256).

Any failed check raises, so the script exits non-zero and prints no
result. ``--json PATH`` also writes every case, time and count to PATH.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_PHASES = 17

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12  # f32 outside the tensor cores
PEAK_TF32_FLOP_S = 495e12  # dense TF32 on the tensor cores
SFU_PER_SM_CLOCK = 16  # exp2 / tanh results an SM's SFUs give a clock

C_SERVE = 173_520  # sasrec-sce's shard-even catalog slice
N_ITEMS = 173_511
D = 64
K = 10
BUCKETS = (8, 32, 512)
NEG_INF = -1e30
ID_PAD = 2**31 - 1
EVAL_B = (128, 256)  # users per evaluation: the trainer's, the eval phase's
KS = (1, 5, 10)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
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


def run_case(name, q, y, k, *, valid=None, id_offset=0, exact=False,
             kcap=None):
    """Kernel vs plain version on one input; returns a result dict. Above
    k = 32 it also reports the chain's per-row collect counts (rows above
    ``kcap`` were finished by the split sweep); ``kcap`` replaces the
    plan's."""
    import torch

    from repro_torch.kernels.mips_topk import SMALL_K, mips_topk
    from repro_torch.kernels.ref import mips_topk_ref

    got = mips_topk(q, y, k, valid=valid, id_offset=id_offset, kcap=kcap)
    torch.cuda.synchronize()
    collect = None
    if min(k, y.shape[0]) > SMALL_K:
        counts = mips_topk.last_counts.float()
        collect = {"mean": counts.mean().item(),
                   "max": int(counts.max().item()),
                   "overflow_rows": int((counts > (
                       kcap or _kcap(q, y, k))).sum().item())}
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
    more = "" if collect is None else (
        f" collected mean {collect['mean']:.1f} max {collect['max']}, "
        f"{collect['overflow_rows']} rows finished by the split sweep")
    print(f"  case {name}: n_q={q.shape[0]} C={c} d={q.shape[1]} k={kk} "
          f"id_offset={id_offset} max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'bitwise' if exact else 'gap-aware'} ID_PAD={n_pad}{more} ok")
    return {"name": name, "n_q": q.shape[0], "C": c, "d": q.shape[1],
            "k": kk, "max_abs_err": err, "tol": tol, "exact": exact,
            "id_pad_slots": n_pad, "collect": collect}


def _kcap(q, y, k):
    """The plan's collect buffer per row of a k > 32 call."""
    import torch

    from repro_torch.kernels.mips_topk import select_plan

    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    return select_plan(q.shape[0], y.shape[0], q.shape[1],
                       min(k, y.shape[0]), n_sm).kcap


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


def tf32x3_bound(nbytes, flops, exps):
    """The least time of a kernel that runs its ``flops`` in 3xTF32 on the
    tensor cores: the largest of three TF32 passes at the dense TF32 rate,
    its ``exps`` at the SFUs' rate (16 a clock per SM at the card's top SM
    clock) and its bytes. Returns ``(ms, "bytes" | "operations", basis,
    f32_ms)``, the same FLOPs' f32 FMA bound (:func:`roofline_ms`) last."""
    import torch

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cands = {"3xTF32 tensor cores": 3 * flops / PEAK_TF32_FLOP_S * 1e3,
             "SFU exps": exps / (SFU_PER_SM_CLOCK * n_sm * sm_clock_hz())
             * 1e3,
             "bytes": nbytes / PEAK_BYTES_S * 1e3}
    basis = max(cands, key=cands.get)
    return (cands[basis], "bytes" if basis == "bytes" else "operations",
            basis, roofline_ms(nbytes, flops)[0])


def f32_bound(nbytes, flops):
    """:func:`roofline_ms` in :func:`tf32x3_bound`'s form, for a kernel of
    f32 FMAs."""
    ms, by = roofline_ms(nbytes, flops)
    return ms, by, "bytes" if by == "bytes" else "f32 FMAs", ms


def bound_keys(bound):
    """A timing's bound keys from a :func:`roofline_ms` pair or a
    :func:`tf32x3_bound` / :func:`f32_bound` quadruple (with its basis and
    the f32 FMA bound)."""
    keys = {"bound_ms": bound[0], "bound_by": bound[1]}
    if len(bound) == 4:
        keys.update(bound_basis=bound[2], bound_f32_ms=bound[3])
    return keys


def bound_text(t):
    """A timing's bound as printed: ms, what bounds it and, for a 3xTF32
    kernel, its f32 FMA bound."""
    if t.get("bound_basis") in (None, "bytes", "f32 FMAs"):
        return f"{t['bound_ms']:.4f} ms ({t['bound_by']})"
    return (f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bound_basis']}; "
            f"as f32 FMAs {t['bound_f32_ms']:.4f} ms)")


def unmasked_pairs(tgt, cand):
    """The (position, candidate) pairs of the buckets that are not masked
    (a candidate with a negative id or equal to the position's target):
    the exps the backward's data needs."""
    return int(((cand[:, None, :] >= 0)
                & (cand[:, None, :] != tgt[:, :, None])).sum())


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
    gate = [v for v in health["conformance"] if v["kernel"] == "mips_topk"]
    check(health["ready"] and health["readiness_error"] is None
          and gate and gate[0]["passed"],
          f"the server did not become ready through its gate: {health}")
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
        "ready": health["ready"], "guard_policy": health["guard_policy"],
        "conformance": health["conformance"],
    }
    print(f"  server: set-up {setup_s:.2f} s ({warm_launches} warm-up "
          f"launches); {n_async} async requests in waves {waves}: "
          f"{out['async_req_s']:.1f} req/s, p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms (n={n_async}, p99 = max); bulk 512 in "
          f"{bulk_s * 1e3:.3f} ms ({out['bulk_req_s']:.1f} req/s); "
          f"mips_topk launches {launches}; cache_misses 0; oracle max err "
          f"{max(errs):.3e} (tol {tol:.3e}); ready through its gate "
          f"(guard {health['guard_policy']}, {len(health['conformance'])} "
          f"verdicts in health())")
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


def gather_bounds(x_b, y, idx, tgt, cand):
    """Least times of the three kernels on these inputs, as
    ``(ms, by, basis, f32_ms)``: each reads x_b, the distinct catalog rows
    it gathers, the ids and its per-row inputs once and writes its outputs
    once; the forward does 2·n_b·b_x·b_y·d f32 FLOPs (f32 FMAs), dX and dY
    twice that (the logits again, then a product of the same size) in
    3xTF32 on the tensor cores, with an exp per unmasked pair
    (:func:`tf32x3_bound`; the f32 FMA bound beside it)."""
    import torch

    n_b, b_x, d = x_b.shape
    b_y = idx.shape[1]
    rows = int(torch.unique(idx).numel())
    common = 4 * (n_b * b_x * d + rows * d + 2 * n_b * b_y)
    flops = 2 * n_b * b_x * b_y * d
    exps = unmasked_pairs(tgt, cand)
    return {
        "sce_gather_fwd": f32_bound(common + 4 * 4 * n_b * b_x, flops),
        "sce_gather_dx": tf32x3_bound(
            common + 4 * 3 * n_b * b_x + 4 * n_b * b_x * d, 2 * flops, exps),
        "sce_gather_dy": tf32x3_bound(
            common + 4 * 3 * n_b * b_x + 4 * y.shape[0] * d, 2 * flops,
            exps),
    }


SHARDS = 4  # the exact-mode shard of phase 6: shard 0 of a 4-way catalog


def plse_case(name, x_b, y, idx, tgt, cand, cap=None):
    """The three ``sce_gather_plse`` launches (forward, dX, dY) against
    autograd through the plain version on one input, for a random
    upstream cotangent. Rows whose candidates are all masked must come out
    at exactly ``NEG_INF`` (finite) with exactly 0 in dX. Returns the
    case's max errors; raises on disagreement."""
    import torch

    from repro_torch.kernels import ops, ref

    g = torch.rand(x_b.shape[:2], device=x_b.device,
                   generator=torch.Generator(device=x_b.device).manual_seed(6))
    got_l = [t.clone().requires_grad_(True) for t in (x_b, y)]
    plse = ops.sce_gather_plse(got_l[0], got_l[1], idx, tgt, cand,
                               logit_softcap=cap)
    got = [plse.detach()] + list(torch.autograd.grad((plse * g).sum(), got_l))
    want_l = [t.clone().requires_grad_(True) for t in (x_b, y)]
    wplse = ref.sce_gather_plse_ref(want_l[0], want_l[1], idx, tgt, cand, cap)
    want = [wplse.detach()] + list(torch.autograd.grad((wplse * g).sum(),
                                                       want_l))
    torch.cuda.synchronize()
    dead = ((cand[:, None, :] < 0)
            | (cand[:, None, :] == tgt[:, :, None])).all(dim=-1)
    check(bool(torch.isfinite(got[0]).all()), f"{name}: a plse is not finite")
    check(bool((got[0][dead] == NEG_INF).all()
               and (want[0][dead] == NEG_INF).all()),
          f"{name}: a row with no unmasked candidate is not NEG_INF")
    check(bool((got[1][dead] == 0).all()),
          f"{name}: dX of a row with no unmasked candidate is not 0")
    errs = {}
    for what, a, b, rtol, keep in (("plse", got[0], want[0], 0.0, ~dead),
                                   ("dx", got[1], want[1], 2e-4, None),
                                   ("dy", got[2], want[2], 2e-4, None)):
        if keep is not None:
            a, b = a[keep], b[keep]
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{name}: {what} shape or finiteness")
        err = (a - b).abs()
        tol = 1e-5 * b.abs().max().item()
        check(bool((err <= tol + rtol * b.abs()).all()),
              f"{name}: {what} differs by {err.max().item():.3e} "
              f"(tol {tol:.3e} + {rtol}·|want|)")
        errs[what] = err.max().item()
    touched = torch.zeros(y.shape[0], dtype=torch.bool, device=y.device)
    touched[idx.long()[cand >= 0]] = True
    check(bool((got[2][~touched] == 0).all()),
          f"{name}: a dY row no unmasked candidate gathers is not exactly 0")
    n_b, b_x, d = x_b.shape
    masked = float((cand < 0).float().mean())
    print(f"  case {name}: n_b={n_b} b_x={b_x} b_y={idx.shape[1]} d={d} "
          f"C={y.shape[0]} cap={cap} cand<0 {masked:.1%}, {int(dead.sum())} "
          f"rows with no unmasked candidate (NEG_INF, dX 0); max err plse "
          f"{errs['plse']:.3e} dX {errs['dx']:.3e} dY {errs['dy']:.3e} ok")
    return {"name": name, "n_b": n_b, "b_x": b_x, "b_y": idx.shape[1],
            "d": d, "C": y.shape[0], "cap": cap, "cand_masked": masked,
            "dead_rows": int(dead.sum()), "max_abs_err": errs}


def plse_bounds(x_b, y, idx, tgt, cand):
    """Least times of the three partial-LSE launches on these inputs, as
    :func:`gather_bounds`: each reads x_b, the distinct catalog rows its
    unmasked candidates gather, the ids and its per-row inputs once and
    writes its outputs once; the forward does 2·d f32 FLOPs per unmasked
    (row, candidate) pair, dX and dY twice that in 3xTF32 with an exp per
    pair."""
    import torch

    n_b, b_x, d = x_b.shape
    b_y = idx.shape[1]
    pairs = unmasked_pairs(tgt, cand)
    rows = int(torch.unique(idx[cand >= 0]).numel())
    common = 4 * (n_b * b_x * d + rows * d + 2 * n_b * b_y + n_b * b_x)
    flops = 2 * pairs * d
    return {
        "sce_gather_plse_fwd": f32_bound(common + 4 * n_b * b_x, flops),
        "sce_gather_plse_dx": tf32x3_bound(
            common + 4 * 2 * n_b * b_x + 4 * n_b * b_x * d, 2 * flops,
            pairs),
        "sce_gather_plse_dy": tf32x3_bound(
            common + 4 * 2 * n_b * b_x + 4 * y.shape[0] * d, 2 * flops,
            pairs),
    }


# The k > 32 chain's kernels, by a part of their names, and its steps.
CHAIN_STEPS = (("pass_kernel<false>", "threshold"), ("tau_kernel", "tau"),
               ("pass_kernel<true>", "collect"), ("select_kernel", "select"),
               ("finish_", "finish"))


def chain_steps(fn, flush, reps=10):
    """Each step's device time per call of ``fn`` (a k > 32 ``mips_topk``),
    from ``torch.profiler`` over ``reps`` calls, each after the L2 flush;
    None for a step the profiler saw no device time of."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    steps = dict.fromkeys((s for _, s in CHAIN_STEPS), 0.0)
    for ev in prof.key_averages():
        for part, step in CHAIN_STEPS:
            if "mips_topk" in ev.key and part in ev.key:
                steps[step] += ev.device_time_total / reps / 1e3
    return {s: t or None for s, t in steps.items()}


def train_kernel_phase(dev):
    import torch

    from repro_torch.core import sce
    from repro_torch.kernels import ref, sce_prefetch
    from repro_torch.kernels.mips_topk import TILE_C, mips_topk, select_plan
    from repro_torch.kernels.ref import mips_topk_ref

    g = torch.Generator(device=dev).manual_seed(1)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

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
    # The chain's adversarial inputs at the training shapes, integer
    # valued (exact): every row's best columns in one residue of the
    # threshold pass's tiles — over the positions one split holds them
    # all, over the catalog they lie in tiles its 1/R sample skips —;
    # all-equal scores; and a collect buffer of k entries, which sends
    # every row of the catalog selection to the split sweep.
    sp_pos = select_plan(N_B, N_POS, D, B_X, n_sm)
    sp_cat = select_plan(N_B, C_SERVE, D, B_Y, n_sm)

    def clustered(c, period, residue):
        hot = (torch.arange(c, device=dev) // TILE_C) % period == residue
        cat = randint(-2, 3, c, D)
        cat[hot] = randint(3, 6, int(hot.sum()), D)
        return randint(1, 3, N_B, D), cat

    cases.append(run_case("clustered_positions_k320",
                          *clustered(N_POS, sp_pos.period, 1), B_X,
                          valid=valid, exact=True))
    cases.append(run_case("clustered_catalog_k256",
                          *clustered(C_SERVE, sp_cat.period,
                                     sp_cat.n_split + 1), B_Y, exact=True))
    cases.append(run_case("all_equal_positions_k320",
                          torch.ones(N_B, D, device=dev),
                          torch.ones(N_POS, D, device=dev), B_X,
                          valid=valid, exact=True))
    cases.append(run_case("overflow_catalog_k256", randint(-2, 3, N_B, D),
                          randint(-2, 3, C_SERVE, D), B_Y, exact=True,
                          kcap=B_Y))
    check(cases[-1]["collect"]["overflow_rows"] == N_B,
          "the k-entry buffer left rows to the select")

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

    # The partial LSE of the distributed exact mode: on one card (the
    # (1, 1) mesh the trainer runs) every candidate of the global top-256
    # is owned; on shard 0 of a 4-way catalog those another shard owns
    # arrive as cand = −1 (≈ 75 %), the rows clamped into the slice.
    pcases = [plse_case("plse_train_shape", x_b, y, idx_y, tgt_b, idx_y)]
    c_l = C_SERVE // SHARDS
    own = idx_y < c_l
    idx_l = idx_y.clamp(max=c_l - 1)
    cand_l = torch.where(own, idx_y, -1)
    y_l = y[:c_l]
    pcases.append(plse_case(f"plse_shard0_of_{SHARDS}", x_b, y_l, idx_l,
                            tgt_b, cand_l))
    cand_nc = cand_l.clone()
    cand_nc[:16] = -1  # buckets that own no candidate at all
    tgt_nc = tgt_b.clone()
    first = cand_l.gather(1, own.to(torch.int32).argmax(1, keepdim=True))
    tgt_nc[16:48, :B_X // 2] = first[16:48]  # collide with an owned one
    pcases.append(plse_case("plse_no_owned_collisions", x_b, y_l, idx_l,
                            tgt_nc, cand_nc))
    pcases.append(plse_case("plse_shard_cap30", x_b * 8.0, y_l, idx_l,
                            tgt_b, cand_l, cap=30.0))
    rows = torch.stack([torch.randperm(300, generator=g, device=dev)[:50]
                        for _ in range(7)]).to(torch.int32)
    cand_r = torch.where(torch.rand(7, 50, generator=g, device=dev) < 0.5,
                         rows, -1)
    cand_r[0] = -1
    pcases.append(plse_case(
        "plse_ragged_d33_cap30", randn(7, 23, 33, scale=8.0), randn(300, 33),
        rows, torch.randint(0, 300, (7, 23), generator=g, device=dev,
                            dtype=torch.int32), cand_r, cap=30.0))

    # The guard's preflight trusts the wrapper's copy of dX / dY's launch
    # plan (sce_prefetch.planned_smem): hold it equal to the library's.
    for d in range(1, sce_prefetch.MAX_D + 1):
        mine, lib = sce_prefetch.bwd_plan(d), sce_prefetch.library_bwd_plan(d)
        check(mine == lib, f"sce_gather backward plan at d={d}: wrapper "
              f"{mine}, library {lib}")
    print("  sce_gather backward plan: the wrapper's copy equals the "
          "library's at every d <= 256")

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
        timings[name]["steps_ms"] = chain_steps(kernel, flush)
        print(f"  steps {name}: " + ", ".join(
            f"{s} {'not measured' if t is None else f'{t:.4f}'}"
            for s, t in timings[name]["steps_ms"].items()) + " ms")

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
    bounds = gather_bounds(x_b, y, idx_y, tgt_b, idx_y)
    # The partial LSE on the main path's input (one card: every candidate
    # owned) and on the shard of 4. Library: bmm + logsumexp on the
    # pre-gathered rows, the mask folded in as baddbmm's additive input.
    for sfx, (cat, ids, cand) in (("", (y, idx_y, idx_y)),
                                  ("_shard4", (y_l, idx_l, cand_l))):
        pargs = (x_b, cat, ids, tgt_b, cand)
        plse = sce_prefetch.sce_gather_plse_fwd(*pargs)
        pleaves = [t.clone().requires_grad_(True) for t in (x_b, cat)]
        pout = (ref.sce_gather_plse_ref(pleaves[0], pleaves[1], *pargs[2:])
                * g_up).sum()
        cat_b = cat[ids.long()]
        bias = torch.where((cand[:, None, :] < 0)
                           | (cand[:, None, :] == tgt_b[:, :, None]),
                           NEG_INF, 0.0)
        pb = plse_bounds(*pargs)
        runs.update({
            f"sce_gather_plse_fwd{sfx}": (
                lambda a=pargs: sce_prefetch.sce_gather_plse_fwd(*a),
                lambda a=pargs: ref.sce_gather_plse_ref(*a),
                lambda yb=cat_b, bi=bias: torch.logsumexp(
                    torch.baddbmm(bi, x_b, yb.transpose(1, 2)), dim=-1)),
            f"sce_gather_plse_dx{sfx}": (
                lambda a=pargs, p=plse: sce_prefetch.sce_gather_plse_dx(
                    *a, p, g_up),
                lambda o=pout, lv=pleaves: torch.autograd.grad(
                    o, lv[0], retain_graph=True),
                lambda yb=cat_b: torch.bmm(probs, yb)),
            f"sce_gather_plse_dy{sfx}": (
                lambda a=pargs, p=plse: sce_prefetch.sce_gather_plse_dy(
                    *a, p, g_up),
                lambda o=pout, lv=pleaves: torch.autograd.grad(
                    o, lv[1], retain_graph=True),
                lambda: torch.bmm(probs.transpose(1, 2), x_b)),
        })
        bounds.update({k + sfx: v for k, v in pb.items()})
    # The composed PyTorch computation of dX and dY on the pre-gathered
    # candidates (the library call above is its second product alone):
    # the logits bmm, exp(l − lse)·g on the unmasked candidates, the
    # second bmm, and for dY index_add_ of the gathered rows into (C, d).
    masked = (idx_y[:, None, :] < 0) | (idx_y[:, None, :] == tgt_b[:, :, None])

    def composed(lse_, dy):
        p = torch.where(masked, 0.0, torch.exp(
            torch.bmm(x_b, y_b.transpose(1, 2)) - lse_[..., None])
            * g_up[..., None])
        if not dy:
            return torch.bmm(p, y_b)
        out = torch.zeros_like(y)
        return out.index_add_(0, idx_y.reshape(-1).long(), torch.bmm(
            p.transpose(1, 2), x_b).reshape(-1, D))

    plse_main = sce_prefetch.sce_gather_plse_fwd(x_b, y, idx_y, tgt_b, idx_y)
    composed_runs = {
        "sce_gather_dx": lambda: composed(lse, False),
        "sce_gather_dy": lambda: composed(lse, True),
        "sce_gather_plse_dx": lambda: composed(plse_main, False),
        "sce_gather_plse_dy": lambda: composed(plse_main, True),
    }
    with torch.no_grad():
        for name, (kern, plain, lib) in runs.items():
            timings[name] = {"ms": time_ms(kern, 20, flush),
                             "plain_ms": time_ms(plain, 5, flush),
                             "library_ms": time_ms(lib, 20, flush),
                             **bound_keys(bounds[name])}
            if name in composed_runs:
                timings[name]["composed_ms"] = time_ms(composed_runs[name],
                                                       20, flush)
    for name, t in timings.items():
        more = (f", composed {t['composed_ms']:.4f} ms" if "composed_ms" in t
                else "")
        print(f"  time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms"
              f"{more}, bound {bound_text(t)}")
    return cases, gcases, pcases, timings


# ---------------------------------------------------------------------------
# The trainer at full width
# ---------------------------------------------------------------------------
TRAIN_STEPS = 30
EVAL_EVERY = 10


PHASES = ("h2d", "forward", "select", "loss_forward", "backward",
          "optimizer")
EVAL_PHASES = ("h2d", "forward", "sweep", "fold")


class StepMarks:
    """The ``mark`` hook of ``launch/train.py::train`` (``phases``
    ``PHASES``) and of ``eval/harness.py::evaluate_streaming``
    (``EVAL_PHASES``): a CUDA event where each phase of each step ends
    (``"start"`` opens a step), read after the run. The device timeline
    between two events includes any wait for the host to enqueue the
    next launch."""

    def __init__(self, phases=PHASES):
        self.phases = phases
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
        sums = dict.fromkeys(self.phases, 0.0)
        for marks in self.steps[skip:]:
            names = [n for n, _ in marks]
            check(names == ["start", *self.phases], f"phase marks {names}")
            for (_, a), (name, b) in zip(marks, marks[1:]):
                sums[name] += a.elapsed_time(b)
        n = len(self.steps) - skip
        return {f"{k}_ms": v / n for k, v in sums.items()}


GATHER = ("sce_gather_fwd", "sce_gather_dx", "sce_gather_dy")
PLSE = ("sce_gather_plse_fwd", "sce_gather_plse_dx", "sce_gather_plse_dy")


def train_phase(dev, sce_mode, guard_policy=None, fresh=()):
    """The trainer at full width in ``sce_mode``: ``"gspmd"`` runs
    ``core/sce.py``'s loss through the three ``sce_gather`` launches,
    ``"exact"`` (the trainer's default) ``core/distributed_sce.py`` on the
    (1, 1) mesh through the three ``sce_gather_plse`` launches; each
    family is launched once a step and the other never.

    ``guard_policy`` is the kernel guard's policy for the run (``None``:
    the default, ``warn``). The verdicts of the groups in ``fresh`` are
    dropped first, so their canaries run at the first dispatch inside the
    run and must pass; their own launches (each verdict's count) are
    taken out before the main path's counts are checked. Under a policy
    other than ``off`` every step's sentinels must be zero; the loss cap
    is ``inf`` for the first 8 steps and finite from the 9th on."""
    import statistics

    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.core import sce
    from repro_torch.kernels import eval_fused, guard, sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk
    from repro_torch.launch.train import train

    cfg = make_config()
    counters = (mips_topk, *(getattr(sce_prefetch, n) for n in GATHER + PLSE),
                eval_fused.eval_fused, eval_fused.eval_tgt_gather)
    marks = StepMarks()
    gc.collect()  # what earlier phases left in reference cycles
    torch.cuda.synchronize()
    live_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for group in fresh:
        guard.clear_verdicts(group)
    for fn in counters:  # the main path starts here
        fn.launches = 0
    mips_topk.launches_by_k.clear()
    t0 = time.monotonic()
    out = train("sasrec-sce", cfg=cfg, batch=N_POS // cfg.max_len,
                steps=TRAIN_STEPS, seed=0, sce_mode=sce_mode, log_every=10,
                eval_every=EVAL_EVERY, eval_users=EVAL_B[0], device=dev,
                guard_policy=guard_policy, mark=marks)
    wall_s = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in counters}  # ... ends here
    by_k = dict(mips_topk.launches_by_k)
    peak = torch.cuda.max_memory_allocated(dev)
    policy = guard.policy()
    guard.set_policy(None)
    run_verdicts = {v["kernel"]: v for v in guard.verdict_table()
                    if v["kernel"] in fresh}
    check(set(run_verdicts) == set(fresh),
          f"verdicts run in the trainer: {sorted(run_verdicts)}, not "
          f"{sorted(fresh)}")
    canary = {}
    for v in run_verdicts.values():
        check(v["passed"], f"{v['kernel']} failed its canaries in the "
              f"trainer: {v['failures']}")
        for name, n in v["launches"].items():
            canary[name] = canary.get(name, 0) + n
    launches = {k: n - canary.get(k, 0) for k, n in launches.items()}
    check(sum(n for k, n in by_k.items() if k not in (B_X, B_Y))
          == canary.get("mips_topk", 0), f"mips_topk by k {by_k}")
    by_k = {k: n for k, n in by_k.items() if k in (B_X, B_Y)}
    sentinels = out["sentinels"]
    if policy == "off":
        check(all(s_ == {} for s_ in sentinels), "sentinels under off")
    else:
        check(all(s_ == {"sce_bucket_nonfinite": 0} for s_ in sentinels),
              f"a sentinel tripped: {sentinels}")
    caps = out["loss_caps"]
    check(all(c == math.inf for c in caps[:8])
          and all(math.isfinite(c) for c in caps[8:]),
          f"loss caps {caps}")
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
    on = PLSE if sce_mode == "exact" else GATHER
    for name in GATHER + PLSE:
        want = TRAIN_STEPS if name in on else 0
        check(launches[name] == want,
              f"{sce_mode}: {name} launched {launches[name]} times in "
              f"{TRAIN_STEPS} steps, not {want}")
    n_evals = TRAIN_STEPS // EVAL_EVERY
    for name in ("eval_fused", "eval_tgt_gather"):
        check(launches[name] == n_evals,
              f"{name} launched {launches[name]} times in {n_evals} "
              f"evaluations")
    check(set(out.get("eval", {})) == {f"{m}@{k}" for m in ("hr", "ndcg",
                                                           "cov")
                                       for k in KS}, "no eval metrics")
    median_ms = statistics.median(out["step_s"][1:]) * 1e3
    eval_s = wall_s - sum(out["step_s"])
    print(f"  trainer (sce_mode={sce_mode}): {TRAIN_STEPS} steps of batch "
          f"{N_POS // cfg.max_len} "
          f"× L {cfg.max_len}, C {cfg.catalog_loss_size}, in {wall_s:.2f} s; "
          f"loss {losses[0]:.4f} → {losses[-1]:.4f} (mean of first 5 "
          f"{first:.4f}, last 5 {last:.4f}); median step {median_ms:.3f} ms "
          f"(host clock, steps 2–{TRAIN_STEPS}, evaluations excluded); "
          f"{n_evals} evaluations of {EVAL_B[0]} users and set-up "
          f"{eval_s:.2f} s (wall − Σ steps); launches {launches}, "
          f"mips_topk by k {by_k}; guard {policy}: verdicts run in the "
          f"trainer {sorted(run_verdicts)} (their canary launches {canary} "
          f"not counted above), "
          f"{'no sentinels' if policy == 'off' else 'sentinels zero'} every "
          f"step, loss cap inf for steps 1–8 and finite from step 9 "
          f"({caps[8]:.4g})")
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
    return {"sce_mode": sce_mode, "losses": losses, "step_s": out["step_s"],
            "wall_s": wall_s, "median_step_ms": median_ms,
            "launches": launches, "guard_policy": policy,
            "verdicts_in_run": sorted(run_verdicts),
            "canary_launches": canary, "loss_caps": caps,
            "eval": out["eval"], "eval_and_setup_s": eval_s,
            "mips_topk_launches_by_k": by_k, "breakdown": bd, "memory": mem}


def mode_agreement_phase(dev):
    """One full-width batch through the three SCE modes on one injected
    Ω: ``gspmd`` (``sce_loss``), and ``exact`` and ``union``
    (``sce_loss_sharded`` on the (1, 1) mesh, where both select what
    ``gspmd`` selects). Losses within ``1e-5·|loss|``, the gradients of x
    and y within ``1e-5·max|g|`` plus ``2e-4·|g|`` of ``gspmd``'s."""
    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.core.distributed_sce import sce_loss_sharded
    from repro_torch.core.sce import sce_loss
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_sce_config
    from repro_torch.launch.train import to_device
    from repro_torch.models import sasrec

    cfg = make_config()
    batch = N_POS // cfg.max_len
    params = sasrec.init_params(cfg, seed=0, device=dev)
    host, _ = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len,
        batch_size=batch)).next_batch(Cursor(seed=0))
    b = to_device(host, dev)
    with torch.no_grad():
        x = sasrec.forward(params, cfg, b["tokens"]).reshape(N_POS, -1)
        y = sasrec.loss_catalog(params, cfg).clone()
    t, valid = b["targets"].reshape(-1), b["valid"].reshape(-1)
    sce_cfg = build_sce_config(N_POS, cfg.n_items,
                               bucket_size_y=B_Y)
    omega = torch.randn((sce_cfg.n_buckets, N_POS), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
    mesh = make_host_mesh(max_data=batch)
    check(mesh.shape == {"data": 1, "model": 1}, f"mesh {mesh.shape}")
    res = {}
    for mode in ("gspmd", "exact", "union"):
        xl, yl = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        if mode == "gspmd":
            loss = sce_loss(xl, yl, t, cfg=sce_cfg, valid_mask=valid,
                            omega=omega)
        else:
            loss = sce_loss_sharded(xl, yl, t, cfg=sce_cfg, mesh=mesh,
                                    valid_mask=valid, mode=mode, omega=omega)
        res[mode] = (loss.item(), *torch.autograd.grad(loss, (xl, yl)))
    torch.cuda.synchronize()
    want = res["gspmd"]
    errs = {}
    for mode in ("exact", "union"):
        got = res[mode]
        lerr = abs(got[0] - want[0])
        check(math.isfinite(got[0]) and lerr <= 1e-5 * abs(want[0]),
              f"{mode}: loss {got[0]} vs gspmd {want[0]}")
        errs[mode] = {"loss": lerr}
        for what, a, w in (("dx", got[1], want[1]), ("dy", got[2], want[2])):
            err = (a - w).abs()
            tol = 1e-5 * w.abs().max().item()
            check(bool(torch.isfinite(a).all()
                       and (err <= tol + 2e-4 * w.abs()).all()),
                  f"{mode}: {what} differs from gspmd by "
                  f"{err.max().item():.3e} (tol {tol:.3e} + 2e-4·|g|)")
            errs[mode][what] = err.max().item()
        print(f"  {mode} vs gspmd: loss {got[0]:.6f} vs {want[0]:.6f} "
              f"(|Δ| {lerr:.3e}), max |Δ| dX {errs[mode]['dx']:.3e}, dY "
              f"{errs[mode]['dy']:.3e} ok")
    return {"losses": {m: r[0] for m, r in res.items()}, "max_abs_err": errs}


# ---------------------------------------------------------------------------
# Eval kernels against their plain versions
# ---------------------------------------------------------------------------
def rank_band(x, y, t, ok, gid, tol):
    """Per row, the least and the most 0-based rank of the target that a
    dense f64 oracle allows when valid scores within ``tol`` of it may
    fall on either side (the target's own column left out); also the
    dense f64 scores, masked to NEG_INF off the valid columns."""
    import torch

    s64 = x.double() @ y.double().T
    c = y.shape[0]
    local = t.long() - int(gid[0])
    owned = (local >= 0) & (local < c)
    t64 = torch.where(owned, s64.gather(1, local.clamp(0, c - 1)[:, None])[:, 0],
                      0.0)
    other = ok[None, :] & (gid[None, :] != t[:, None])
    lo = ((s64 > t64[:, None] + tol) & other).sum(1)
    hi = ((s64 >= t64[:, None] - tol) & other).sum(1)
    return lo, hi, torch.where(ok[None, :], s64, NEG_INF)


def eval_case(name, x, y, t, k, *, c_lo, c_hi, id_offset=0, cap=None,
              with_lse=False, exact=False):
    """``eval_fused`` (and the ``eval_tgt_gather`` it calls) against the
    plain version on one input; returns the case's errors, raises on
    disagreement."""
    import torch

    from repro_torch.kernels import ops, ref

    kw = dict(c_lo=c_lo, c_hi=c_hi, id_offset=id_offset, logit_softcap=cap,
              with_lse=with_lse)
    vals, ids, gt, eq, tgt, m, s = ops.eval_fused(x, y, t, k, **kw)
    torch.cuda.synchronize()
    want = ref.eval_fused_ref(x, y, t, k, **kw)
    dev = x.device
    gid = id_offset + torch.arange(y.shape[0], device=dev)
    ok = (gid >= c_lo) & (gid < c_hi)
    scale = (x.double() @ y.double().T)[:, ok].abs().max().item()
    tol = 1e-5 * scale
    lo, hi, s64 = rank_band(x, y, t, ok, gid, tol)
    rank = gt + (eq - 1).clamp_min(0)
    check(bool(((rank >= lo) & (rank <= hi)).all()),
          f"{name}: a rank outside the f64 band")
    err = (vals - want[0]).abs().max().item()
    tgt_err = (tgt - want[4]).abs().max().item()
    if exact:
        for what, a, b in zip(("vals", "ids", "gt", "eq", "tgt"),
                              (vals, ids, gt, eq, tgt), want[:5]):
            check(torch.equal(a, b), f"{name}: {what} differ on exact inputs")
    else:
        check(err <= tol, f"{name}: values differ by {err} > {tol}")
        check(tgt_err <= tol, f"{name}: tgt differs by {tgt_err} > {tol}")
        # ids where consecutive dense scores are more than 1e-4·max apart
        top = torch.topk(s64, min(k + 1, s64.shape[1]), dim=1).values
        if top.shape[1] == k:
            top = torch.cat([top, torch.full_like(top[:, :1], NEG_INF)], 1)
        gap = 1e-4 * scale
        prv = torch.cat([torch.full_like(top[:, :1], float("inf")),
                         top[:, :k - 1]], 1)
        isolated = ((prv - top[:, :k]) > gap) & ((top[:, :k] - top[:, 1:])
                                                 > gap)
        check(bool((ids == want[1])[isolated].all()),
              f"{name}: isolated ids differ from the plain version")
    lse_err = 0.0
    if with_lse:
        lse, want_lse = m + torch.log(s), want[5] + torch.log(want[6])
        lse_err = ((lse - want_lse).abs()
                   / want_lse.abs().clamp_min(1e-6)).max().item()
        check(lse_err <= 1e-5, f"{name}: lse relative error {lse_err}")
    hit = ids == t[:, None]
    check(torch.equal(vals[hit], tgt[:, None].expand(-1, k)[hit]),
          f"{name}: a target in the top-k does not carry tgt bit for bit")
    lo_id, hi_id = max(c_lo, id_offset), min(c_hi, id_offset + y.shape[0])
    valid_t = (t >= lo_id) & (t < hi_id)
    check(bool((eq[valid_t] >= 1).all()), f"{name}: eq < 1 on a valid target")
    print(f"  case {name}: B={x.shape[0]} C={y.shape[0]} d={x.shape[1]} k={k} "
          f"window [{c_lo}, {c_hi}) id_offset={id_offset} lse={with_lse} "
          f"cap={cap} max_abs_err vals {err:.3e} tgt {tgt_err:.3e} lse rel "
          f"{lse_err:.3e} (tol {tol:.3e}) {'bitwise' if exact else 'banded'}"
          f"; {int(hit.any(1).sum())} targets in the top-k carry tgt "
          f"exactly; ranks in the f64 band ok")
    return {"name": name, "B": x.shape[0], "C": y.shape[0], "d": x.shape[1],
            "k": k, "with_lse": with_lse, "cap": cap, "exact": exact,
            "max_abs_err": err, "tgt_err": tgt_err, "lse_rel_err": lse_err,
            "tol": tol, "targets_in_topk": int(hit.any(1).sum())}


def eval_bounds(b, c, d, k, n_rows):
    """Least times on these inputs. eval_fused reads x, the catalog, the
    targets and thresholds once, writes (B, k) values and ids and the two
    counts, and does 2·B·C·d f32 FLOPs; eval_tgt_gather reads x, the
    ``n_rows`` distinct target rows and the targets, writes (B,) scores,
    and does 2·B·d."""
    fused = roofline_ms(4 * (b * d + c * d + 2 * b) + 8 * b * k + 8 * b,
                        2 * b * c * d)
    gather = roofline_ms(4 * (b * d + n_rows * d + b) + 4 * b, 2 * b * d)
    return fused, gather


def eval_kernel_phase(dev):
    import torch

    from repro_torch.kernels import eval_fused as ek
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device=dev).to(torch.float32)

    def targets(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    # Full width: states like the final LayerNorm's, the catalog at its
    # init scale; 8 rows get their target planted at the top of the row.
    y = randn(C_SERVE, D, scale=0.02)
    cases, inputs = [], {}
    for b in EVAL_B:
        x = randn(b, D)
        t = targets(b, 1, N_ITEMS)
        y[t[:8].long()] = 0.05 * x[:8]
        inputs[b] = (x, t)
    window = dict(c_lo=1, c_hi=N_ITEMS)
    for b in EVAL_B:
        x, t = inputs[b]
        cases.append(eval_case(f"eval_b{b}", x, y, t, K, **window))
    x, t = inputs[EVAL_B[0]]
    cases.append(eval_case("eval_b128_lse", x, y, t, K, with_lse=True,
                           **window))
    cases.append(eval_case("eval_b128_lse_cap30", x, y, t, K, with_lse=True,
                           cap=30.0, **window))
    yi = randint(-2, 3, C_SERVE, D)
    xi = randint(-2, 3, EVAL_B[0], D)
    cases.append(eval_case("int_ties_b128_lse", xi, yi,
                           targets(EVAL_B[0], 1, N_ITEMS), K, with_lse=True,
                           exact=True, **window))
    cases.append(eval_case("int_ragged_offset_d33", randint(-2, 3, 40, 33),
                           randint(-2, 3, 1_037, 33),
                           targets(40, 1_003, 1_900), 17, c_lo=1_003,
                           c_hi=1_900, id_offset=1_000, cap=30.0,
                           with_lse=True, exact=True))
    cases.append(eval_case("int_k_gt_valid", randint(-2, 3, 9, D),
                           randint(-2, 3, 500, D), targets(9, 3, 9), 12,
                           c_lo=3, c_hi=9, with_lse=True, exact=True))
    xo = randn(24, D)
    to = targets(24, 5_000, 8_000)
    cases.append(eval_case("float_offset", xo, randn(3_000, D), to, K,
                           c_lo=5_001, c_hi=7_990, id_offset=5_000))

    # Times at the evaluation's shapes, cold L2.
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    window_mask = (torch.arange(C_SERVE, device=dev) >= 1) & \
        (torch.arange(C_SERVE, device=dev) < N_ITEMS)
    timings = {}
    for b in EVAL_B:
        x, t = inputs[b]
        tgt = ek.eval_tgt_gather(x, y, t)

        def fused():
            return ek.eval_fused(x, y, t, K, tgt_scores=tgt, **window)

        def fused_plain():
            return ref.eval_fused_ref(x, y, t, K, tgt_scores=tgt, **window)

        def fused_library():
            s_ = torch.where(window_mask[None, :], torch.matmul(x, y.T),
                             NEG_INF)
            return (torch.topk(s_, K), (s_ > tgt[:, None]).sum(1),
                    (s_ == tgt[:, None]).sum(1))

        def gather():
            return ek.eval_tgt_gather(x, y, t)

        def gather_plain():
            return ref.eval_tgt_gather_ref(x, y, t)

        def gather_library():
            return (x * y[t.long()]).sum(-1)

        bf, bg = eval_bounds(b, C_SERVE, D, K,
                             int(torch.unique(t).numel()))
        timings[b] = {
            "eval_fused": {"ms": time_ms(fused, 50, flush),
                           "plain_ms": time_ms(fused_plain, 3, flush),
                           "library_ms": time_ms(fused_library, 50, flush),
                           "bound_ms": bf[0], "bound_by": bf[1]},
            "eval_tgt_gather": {"ms": time_ms(gather, 50, flush),
                                "plain_ms": time_ms(gather_plain, 20, flush),
                                "library_ms": time_ms(gather_library, 50,
                                                      flush),
                                "bound_ms": bg[0], "bound_by": bg[1]},
        }
        for name, tt in timings[b].items():
            print(f"  time {name} B={b}: kernel {tt['ms']:.4f} ms, plain "
                  f"{tt['plain_ms']:.3f} ms, library {tt['library_ms']:.4f} "
                  f"ms, bound {tt['bound_ms']:.4f} ms ({tt['bound_by']})")
    return cases, timings


# ---------------------------------------------------------------------------
# The evaluation at full width
# ---------------------------------------------------------------------------
N_EVAL_BATCHES = 8


def eval_phase(dev):
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.core import metrics
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.eval import (
        MetricAccumulator,
        evaluate_streaming,
        ranks_from_counts,
        sasrec_score_fn,
        streaming_eval_scores,
    )
    from repro_torch.eval.harness import _keep_and_targets
    from repro_torch.kernels import eval_fused as ek
    from repro_torch.kernels.mips_topk import plan
    from repro_torch.models import sasrec

    cfg = make_config()
    b = EVAL_B[1]
    params = sasrec.init_params(cfg, seed=0, device=dev)
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=b,
    ))
    batches = [data.eval_batch(Cursor(seed=0, step=i))[0]
               for i in range(N_EVAL_BATCHES)]
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counters = (ek.eval_fused, ek.eval_tgt_gather)
    for fn in counters:  # the main path starts here
        fn.launches = 0
    acc = MetricAccumulator(KS, cfg.n_items)
    marks = StepMarks(EVAL_PHASES)
    batch_ms = []
    t0 = time.monotonic()
    for batch in batches:
        t1 = time.perf_counter()
        evaluate_streaming(params, cfg, batch, ks=KS, accumulator=acc,
                           mark=marks)
        batch_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {fn.__name__: fn.launches for fn in counters}  # ... ends here
    peak = torch.cuda.max_memory_allocated(dev)
    streamed = acc.result()
    for name, n in launches.items():
        check(n == N_EVAL_BATCHES, f"{name} launched {n} times in "
              f"{N_EVAL_BATCHES} evaluations")

    # The dense on-card oracle, and both sets of ranks against the band.
    dense_acc = MetricAccumulator(KS, cfg.n_items)
    score_fn = sasrec_score_fn(cfg)
    n_amb = n_users = n_same = 0
    tols = []
    for batch in batches:
        scores, tg = metrics.dense_scores(params, cfg, batch)
        dense_rank = metrics.rank_of_target(scores, tg)
        top = torch.sort(scores, dim=1, descending=True,
                         stable=True).indices[:, :max(KS)]
        dense_acc.update(dense_rank, top)
        tokens, targets = _keep_and_targets(batch["tokens"])
        t = torch.from_numpy(targets.astype(np.int32)).to(dev)
        with torch.no_grad():
            x, catalog = score_fn(params, torch.from_numpy(tokens).to(dev))
            _, _, gt, eq, _, _, _ = streaming_eval_scores(
                x, catalog, t, max(KS), c_lo=1, c_hi=cfg.n_items)
        gid = torch.arange(catalog.shape[0], device=dev)
        ok = (gid >= 1) & (gid < cfg.n_items)
        tol = 1e-5 * (x.double() @ catalog.double().T)[:, ok].abs().max()
        lo, hi, _ = rank_band(x, catalog, t, ok, gid, tol.item())
        streamed_rank = torch.from_numpy(ranks_from_counts(gt, eq)).to(dev)
        for what, r in (("streamed", streamed_rank), ("dense", dense_rank)):
            check(bool(((r >= lo) & (r <= hi)).all()),
                  f"{what} rank outside the f64 band")
        n_same += int((streamed_rank == dense_rank).sum())
        n_amb += int((lo != hi).sum())
        n_users += len(targets)
        tols.append(tol.item())
    dense = dense_acc.result()
    breakdown = marks.breakdown()
    print(f"  one evaluation of {b} users: {statistics.median(batch_ms[1:]):.3f}"
          f" ms median host clock (batches 2–{N_EVAL_BATCHES}; first "
          f"{batch_ms[0]:.3f}) = " + " + ".join(
              f"{p} {breakdown[p + '_ms']:.3f}" for p in EVAL_PHASES)
          + f" = {sum(breakdown.values()):.3f} ms (device events of "
          f"evaluate_streaming's own phases, mean of batches "
          f"2–{N_EVAL_BATCHES})")
    for k in KS:
        for m in ("hr", "ndcg"):
            diff = abs(streamed[f"{m}@{k}"] - dense[f"{m}@{k}"])
            check(diff <= n_amb / n_users + 1e-12,
                  f"{m}@{k} streamed {streamed[f'{m}@{k}']} vs dense "
                  f"{dense[f'{m}@{k}']} with {n_amb} ambiguous ranks")
    dense_bytes = 4 * b * cfg.n_items
    pl = plan(b, cfg.catalog_loss_size, cfg.d_model, max(KS),
              torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch_bytes = b * pl.n_split * (8 * max(KS) + 8)
    print(f"  evaluation: {N_EVAL_BATCHES} batches of {b} users × L "
          f"{cfg.max_len}, C {cfg.catalog_loss_size}, in {wall_s:.3f} s "
          f"({n_users} users, {n_users / wall_s:.0f} users/s, host clock); "
          f"launches {launches}; {n_amb} ranks the f64 band leaves open "
          f"(tol ≤ {max(tols):.3e}); {n_same} of {n_users} streamed ranks "
          f"equal the dense oracle's")
    print("  metric    streamed    dense")
    for key in streamed:
        print(f"  {key:8s} {streamed[key]:.6f}  {dense[key]:.6f}")
    print(f"  peak device memory of the streaming evaluation: "
          f"{(peak - live) / 2**20:.1f} MiB above the {live / 2**20:.1f} MiB "
          f"live before it (torch.cuda.max_memory_allocated; the SASRec "
          f"forward's activations included); eval_fused's split scratch "
          f"B·S·(8k + 8) B = {scratch_bytes / 2**20:.2f} MiB (S = "
          f"{pl.n_split}); dense scores B·C·4 B = {dense_bytes / 2**20:.1f} "
          f"MiB per batch")
    return {"batches": N_EVAL_BATCHES, "batch": b, "users": n_users,
            "wall_s": wall_s, "launches": launches, "streamed": streamed,
            "dense": dense, "ambiguous_ranks": n_amb,
            "ranks_equal_to_dense": n_same, "scratch_bytes": scratch_bytes,
            "peak_bytes_above_live": peak - live, "live_bytes": live,
            "dense_score_bytes": dense_bytes, "batch_ms": batch_ms,
            "breakdown": breakdown}


# ---------------------------------------------------------------------------
# Full-CE kernels against their plain versions
# ---------------------------------------------------------------------------
CE_KERNELS = (  # (wrapper, family, output, the TPU kernel it replaces)
    ("linear_ce_fwd", "linear", "fwd", "src/repro/kernels/linear_sce.py:60"),
    ("linear_ce_dx", "linear", "dx", "src/repro/kernels/linear_sce.py:121"),
    ("linear_ce_dw", "linear", "dw", "src/repro/kernels/linear_sce.py:154"),
    ("fused_lse_fwd", "fused", "fwd", "src/repro/kernels/fused_ce.py:34"),
    ("fused_lse_dx", "fused", "dx", "src/repro/kernels/fused_ce.py:69"),
    ("fused_lse_dy", "fused", "dw", "src/repro/kernels/fused_ce.py:102"),
)


def ce_calls(x, w, t, g, lse, cap, planes):
    """Per kernel of ``CE_KERNELS``: ``(kernel call, plain call)`` on these
    inputs; the backward kernels and their plain versions take the same
    ``lse``, the kernels the split ``planes`` of ``x`` and ``w`` (as the
    autograd forward hands them over). ``linear_ce_fwd`` returns
    ``(loss, lse)``, its plain version the loss."""
    from repro_torch.kernels import fused_ce, linear_sce, ref

    kw = dict(logit_softcap=cap)
    bwd = (x, w, t, lse, g)
    return {
        "linear_ce_fwd": (lambda: linear_sce.linear_ce_fwd(x, w, t, **kw,
                                                           planes=planes),
                          lambda: ref.linear_ce_loss_ref(x, w, t, **kw)),
        "linear_ce_dx": (lambda: linear_sce.linear_ce_dx(*bwd, **kw,
                                                         planes=planes),
                         lambda: ref.linear_ce_dx_ref(*bwd, **kw)),
        "linear_ce_dw": (lambda: linear_sce.linear_ce_dw(*bwd, **kw,
                                                         planes=planes),
                         lambda: ref.linear_ce_dw_ref(*bwd, **kw)),
        "fused_lse_fwd": (lambda: fused_ce.fused_lse_fwd(x, w,
                                                         planes=planes),
                          lambda: ref.fused_lse_ref(x, w)),
        "fused_lse_dx": (lambda: fused_ce.fused_lse_dx(x, w, lse, g,
                                                       planes=planes),
                         lambda: ref.linear_ce_dx_ref(x, w, None, lse, g)),
        "fused_lse_dy": (lambda: fused_ce.fused_lse_dy(x, w, lse, g,
                                                       planes=planes),
                         lambda: ref.linear_ce_dw_ref(x, w, None, lse, g)),
    }


def split_calls(x, w):
    """``linear_ce_split`` and its plain version on ``x`` and ``w``."""
    from repro_torch.kernels import linear_sce, ref

    return (lambda: linear_sce.linear_ce_split(x, w),
            lambda: (ref.tf32x3_planes_ref(x), ref.tf32x3_planes_ref(w)))


def ce_case(name, x, w, t, g, *, cap=None):
    """The six full-CE kernels against their plain versions on one input
    (the fused family without the cap, which it does not take), on the
    split kernel's planes, which must equal the plain split bit for bit.
    Values within ``1e-5·max|want|``, gradients within ``1e-5·max|grad|``
    plus ``2e-4·|grad|`` (f32 exp sums fold in another order; the products
    in 3xTF32); rows with a zero cotangent get dX exactly 0. Returns the
    max errors."""
    import torch

    from repro_torch.kernels import ref

    errs = {}
    split, split_plain = split_calls(x, w)
    planes = split()
    for got, want in zip(planes, split_plain()):
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"{name}: linear_ce_split's planes differ from the plain "
              f"version's bits")
    errs["linear_ce_split"] = 0.0
    for family, c_ in (("linear", cap), ("fused", None)):
        lse = ref.fused_lse_ref(x, w, logit_softcap=c_)
        calls = ce_calls(x, w, t, g, lse, c_, planes)
        for kname, fam, what, _ in CE_KERNELS:
            if fam != family:
                continue
            kern, plain = calls[kname]
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if kname == "linear_ce_fwd":
                got_lse, got = got[1], got[0]
                err = (got_lse - lse).abs().max().item()
                check(err <= 1e-5 * lse.abs().max().item(),
                      f"{name}: {kname} lse differs by {err:.3e}")
            rtol = 0.0 if what == "fwd" else 2e-4
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"{name}: {kname} shape or finiteness")
            err = (got - want).abs()
            tol = 1e-5 * want.abs().max().item()
            check(bool((err <= tol + rtol * want.abs()).all()),
                  f"{name}: {kname} differs by {err.max().item():.3e} (tol "
                  f"{tol:.3e} + {rtol}·|want|)")
            if what == "dx":
                check(bool((got[g == 0] == 0).all()),
                      f"{name}: {kname} row with a zero cotangent is not 0")
            errs[kname] = err.max().item()
    n, d = x.shape
    print(f"  case {name}: N={n} C={w.shape[0]} d={d} cap={cap} "
          f"{int((g == 0).sum())} zero-cotangent rows, "
          f"{n - int(torch.unique(t).numel())} repeated targets; max err "
          + " ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " ok")
    return {"name": name, "N": n, "C": w.shape[0], "d": d, "cap": cap,
            "max_abs_err": errs}


def sm_clock_hz():
    """The card's top SM clock (``nvidia-smi clocks.max.sm``)."""
    return float(smi("clocks.max.sm").split()[0]) * 1e6


def ce_bounds(n, c, d):
    """Least times of the full-CE kernels at (N, C, d): each reads x and w
    once (the linear family also the targets), the backward kernels the
    lse and g; each writes its outputs once (loss and lse; lse; dX; dW).
    The forward does 2·N·C·d FLOPs of logits; dX and dW/dY recompute them
    and take a product of the same size, 4·N·C·d FLOPs. All run in 3xTF32
    on the tensor cores: a bound is the largest of three TF32 passes at
    the dense TF32 rate, the N·C exps (no cap) at the SFU rate of the
    card's SMs at its top clock, and the bytes; the f32 FMA bound of the
    same FLOPs stands beside it (``f32_ms``). The split kernel reads x and
    w and writes their planes (two floats per depth, d rounded up to 16):
    bytes. Returns name → ``(ms, "bytes" | "operations", basis,
    f32_ms)``."""
    common = 4 * (n * d + c * d)
    flops = 2 * n * c * d
    out = {}
    for kname, family, what, _ in CE_KERNELS:
        tgt = 4 * n if family == "linear" else 0
        if what == "fwd":
            work = flops
            nbytes = common + tgt + (8 if family == "linear" else 4) * n
        else:
            work = 2 * flops
            written = 4 * (n if what == "dx" else c) * d
            nbytes = common + tgt + 8 * n + written
        out[kname] = tf32x3_bound(nbytes, work, n * c)
    dp = -(-d // 16) * 16
    ms = (common + 8 * (n + c) * dp) / PEAK_BYTES_S * 1e3
    out["linear_ce_split"] = (ms, "bytes", "bytes", ms)
    return out


def ce_kernel_phase(dev):
    import torch

    from repro_torch.kernels import linear_sce, ref

    # The guard's preflight plans the kernels' shared memory with
    # linear_sce.fwd_plan and bwd_plan, copies of the library's plans:
    # hold them equal.
    for d in range(1, linear_sce.MAX_D + 1):
        mine, lib = linear_sce.fwd_plan(d), linear_sce.library_fwd_plan(d)
        check(mine == lib, f"linear_ce forward plan at d={d}: wrapper "
              f"{mine}, library {lib}")
        for dw in (False, True):
            mine = linear_sce.bwd_plan(d, dw)
            lib = linear_sce.library_bwd_plan(d, dw)
            check(mine == lib, f"linear_ce backward plan at d={d} dw={dw}: "
                  f"wrapper {mine}, library {lib}")
    print("  linear_ce forward and backward plans: the wrapper's copies "
          "equal the library's at every d <= 256")

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=dev).to(torch.float32)

    def targets(n, c):
        return torch.randint(0, c, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def cotangent(n):
        return torch.rand(n, generator=gen, device=dev) + 0.5

    # The trainer's shape: hidden states at unit scale, the catalog at a
    # scale that puts the logits near unit variance.
    x = randn(N_POS, D)
    w = randn(C_SERVE, D, scale=0.125)
    t = targets(N_POS, N_ITEMS)
    g = cotangent(N_POS)
    cases = [ce_case("train_shape", x, w, t, g)]
    # cap 30 past its knee, half the targets on the last (ragged: C % 64
    # = 16) catalog row, every third cotangent 0
    t2 = t.clone()
    t2[: N_POS // 2] = C_SERVE - 1
    g2 = g.clone()
    g2[::3] = 0.0
    cases.append(ce_case("train_shape_cap30_dup_zero", 8.0 * x, w, t2, g2,
                         cap=30.0))
    cases.append(ce_case("int_ragged_d33", randint(-2, 3, 1_000, 33),
                         randint(-2, 3, 5_003, 33), targets(1_000, 5_003),
                         cotangent(1_000)))
    ti = targets(300, 3_001)
    ti[:100] = 7
    cases.append(ce_case("int_cap30_d200_dup", randint(-2, 3, 300, 200),
                         randint(-2, 3, 3_001, 200), ti, cotangent(300),
                         cap=30.0))

    # Times at the trainer's shape, cold L2; the library calls hold the
    # (N, C) f32 logits (17.8 GB) and their softmax. The kernels take the
    # planes of one split, timed on its own.
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    lse = ref.fused_lse_ref(x, w)
    split, split_plain = split_calls(x, w)
    calls = ce_calls(x, w, t, g, lse, None, split())
    calls["linear_ce_split"] = (split, split_plain)
    library = {
        "fwd": lambda: torch.logsumexp(x @ w.T, -1),
        "dx": lambda: torch.softmax(x @ w.T, -1) @ w,
        "dw": lambda: torch.softmax(x @ w.T, -1).T @ x,
    }
    bounds = ce_bounds(N_POS, C_SERVE, D)
    timings = {}
    with torch.no_grad():
        for kname, what in [(k, w_) for k, _, w_, _ in CE_KERNELS] + [
                ("linear_ce_split", None)]:
            kern, plain = calls[kname]
            ms, by, basis, f32_ms = bounds[kname]
            timings[kname] = {
                "ms": time_ms(kern, 5, flush),
                "plain_ms": time_ms(plain, 2, flush),
                "library_ms": (None if what is None
                               else time_ms(library[what], 3, flush)),
                "bound_ms": ms, "bound_by": by, "bound_basis": basis,
                "bound_f32_ms": f32_ms,
            }
            tt = timings[kname]
            lib_ms = ("none" if tt["library_ms"] is None
                      else f"{tt['library_ms']:.4f} ms")
            f32 = "" if what is None else f"; as f32 FMAs {f32_ms:.4f} ms"
            print(f"  time {kname}: kernel {tt['ms']:.4f} ms, plain "
                  f"{tt['plain_ms']:.3f} ms, library {lib_ms}, bound "
                  f"{tt['bound_ms']:.4f} ms ({tt['bound_by']}: {basis}"
                  f"{f32})")
    del flush
    torch.cuda.empty_cache()
    return cases, timings


# ---------------------------------------------------------------------------
# The trainer with the competitor losses at full width
# ---------------------------------------------------------------------------
KERNEL_LOSS_STEPS = 20
OTHER_LOSS_STEPS = 3
LOSS_PHASES = ("h2d", "forward", "loss_forward", "backward", "optimizer")
OTHER_LOSSES = ("ce", "ce_chunked", "bce", "bce_plus", "gbce", "ce_minus",
                "ce_inbatch", "ce_pop", "rece")
# The dense `ce` step holds the (N, C) f32 logits, their softmax gradient
# and the gather's scatter: at batch 128 (17.8 GB of logits) it does not
# fit on an H100 80GB (one more 16.55 GiB allocation with 66.8 GiB held),
# so it runs at batch 64.
DENSE_CE_BATCH = 64


def loss_run(dev, cfg, name, steps, batch):
    """``steps`` steps of ``make_seqrec_train_step`` with ``train_loss``
    set to ``name`` (``dataclasses.replace`` of the arch, as a user would),
    from random weights (seed 0) on ``Cursor(seed=0)``'s batches, with the
    loss at its ``make_loss`` defaults as ``_vocab_loss`` calls it."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.launch.steps import make_seqrec_train_step
    from repro_torch.launch.train import to_device
    from repro_torch.models import sasrec

    arch = dataclasses.replace(get_arch("sasrec-sce"), train_loss=name)
    step_fn, (opt_init, _), _ = make_seqrec_train_step(
        arch, cfg, ShapeSpec("train_paper", "train", {"batch": batch}))
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=batch))
    params = sasrec.init_params(cfg, seed=0, device=dev)
    opt_state = opt_init(params)
    gen = torch.Generator(device=dev).manual_seed(0)
    cursor = Cursor(seed=0)
    marks = StepMarks(LOSS_PHASES)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s, skipped = [], [], 0
    for _ in range(steps):
        t0 = time.perf_counter()
        host, cursor = data.next_batch(cursor)
        marks("start")
        dev_batch = to_device(host, dev)
        marks("h2d")
        params, opt_state, m = step_fn(params, opt_state, dev_batch,
                                       generator=gen, mark=marks)
        losses.append(float(m["loss"]))
        skipped += bool(m["skipped"])
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    del params, opt_state
    torch.cuda.empty_cache()
    check(all(math.isfinite(v) for v in losses), f"{name}: a loss is not "
          f"finite")
    check(skipped == 0, f"{name}: {skipped} steps skipped")
    return {"loss": name, "batch": batch, "steps": steps, "losses": losses,
            "step_s": step_s,
            "median_step_ms": statistics.median(step_s[1:]) * 1e3,
            "peak_bytes": peak, "live_bytes_before": live,
            "breakdown": marks.breakdown()}


def loss_phase(dev, trainers):
    import statistics

    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.core import sce
    from repro_torch.core.losses import loss_peak_elements
    from repro_torch.kernels import fused_ce, linear_sce

    cfg = make_config()
    batch = N_POS // cfg.max_len
    counters = {k: getattr(linear_sce if k.startswith("linear") else fused_ce,
                           k) for k, *_ in CE_KERNELS}
    counters["linear_ce_split"] = linear_sce.linear_ce_split
    for fn in counters.values():  # the main path starts here
        fn.launches = 0
    runs, seen = [], dict.fromkeys(counters, 0)
    for name in ("ce_fused_linear", "ce_fused"):
        r = loss_run(dev, cfg, name, KERNEL_LOSS_STEPS, batch)
        first = statistics.mean(r["losses"][:5])
        last = statistics.mean(r["losses"][-5:])
        check(last < first, f"{name}: mean loss of the last 5 steps "
              f"{last:.5f} is not below the first 5's {first:.5f}")
        moved = {k: fn.launches - seen[k] for k, fn in counters.items()}
        family = "linear" if name == "ce_fused_linear" else "fused"
        for kname, fam, *_ in CE_KERNELS + (("linear_ce_split", family),):
            want = KERNEL_LOSS_STEPS if fam == family else 0
            check(moved[kname] == want, f"{name}: {kname} launched "
                  f"{moved[kname]} times in {KERNEL_LOSS_STEPS} steps")
        seen = {k: fn.launches for k, fn in counters.items()}
        bd = r["breakdown"]
        print(f"  {name}: {KERNEL_LOSS_STEPS} steps of batch {batch}, loss "
              f"{r['losses'][0]:.4f} → {r['losses'][-1]:.4f} (mean of first "
              f"5 {first:.4f}, last 5 {last:.4f}); step breakdown "
              + " + ".join(f"{p} {bd[p + '_ms']:.3f}" for p in LOSS_PHASES)
              + f" = {sum(bd.values()):.3f} ms (device events, mean of "
              f"steps 2–{KERNEL_LOSS_STEPS}); launches {moved}")
        runs.append(r)
    for name in OTHER_LOSSES:
        runs.append(loss_run(dev, cfg, name, OTHER_LOSS_STEPS,
                             DENSE_CE_BATCH if name == "ce" else batch))
    launches = {k: fn.launches for k, fn in counters.items()}  # ... ends here
    check(launches == seen, f"a competitor loss launched a CE kernel: "
          f"{launches} after {seen}")

    n, c, d = N_POS, cfg.catalog_loss_size, cfg.d_model
    sce_cfg = sce.SCEConfig.from_alpha_beta(n, cfg.n_items, use_kernel=True)
    print(f"  loss             batch steps  median step ms  peak MiB "
          f"(above live)  loss_peak_elements MiB (×4 B)")
    rows = [{"loss": f"sce {t['sce_mode']} (ph. {ph})", "batch": batch,
             "steps": TRAIN_STEPS,
             "median_step_ms": t["median_step_ms"],
             "peak_bytes": t["memory"]["peak_bytes"],
             "live_bytes_before": t["memory"]["live_bytes_before"],
             "model_elements": loss_peak_elements("sce", n, c, d,
                                                  cfg=sce_cfg)}
            for t, ph in zip(trainers, (7, 8))]
    for r in runs:
        rows.append(dict(r, model_elements=loss_peak_elements(
            r["loss"], r["batch"] * cfg.max_len, c, d)))
    for r in rows:
        print(f"  {r['loss']:16s} {r['batch']:5d} {r['steps']:5d} "
              f"{r['median_step_ms']:14.3f}  {r['peak_bytes'] / 2**20:9.1f} "
              f"({(r['peak_bytes'] - r['live_bytes_before']) / 2**20:9.1f})"
              f"  {4 * r['model_elements'] / 2**20:12.1f}")
    print(f"  (median step: host clock, steps after the first; peak: "
          f"torch.cuda.max_memory_allocated over the run, params, AdamW "
          f"state and activations included; SCE's from phases 7–8, their "
          f"evaluations included; ce at batch {DENSE_CE_BATCH}: at 128 its "
          f"(N, C) logits and their gradients do not fit the card)")
    return {"runs": runs, "table": rows, "launches": launches}


# ---------------------------------------------------------------------------
# The kernel guard: conformance on the card
# ---------------------------------------------------------------------------
def conformance_phase(dev):
    """``run_conformance(refresh=True)`` on the card: the 12 canaries of
    the 7 kernel groups, each kernel against its plain version. The
    canaries are the one path that runs rows 6, 7, 10 and 11 (the two
    SCE-bucket and two two-pass eval kernels); their launches are read
    from counts set to 0 just before. The verdicts stay memoized, so the
    later phases' dispatches consult them without running canaries."""
    import torch

    from repro_torch.kernels import guard
    from repro_torch.kernels.guard.conformance import (
        launch_counts,
        reset_launch_counts,
    )

    guard.set_policy(None)
    reset_launch_counts()  # the main path starts here
    t0 = time.monotonic()
    verdicts = guard.run_conformance(device=dev, refresh=True)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = launch_counts()  # ... and ends here
    n_pass = 0
    for name, v in sorted(verdicts.items()):
        print(f"  verdict {name}: {'PASS' if v.passed else 'FAIL'} "
              f"{v.n_pass}/{v.n_pass + v.n_fail} on {v.device}; launches "
              f"{dict(v.launches)}")
        check(v.passed, f"conformance of {name} failed on the card: "
              f"{'; '.join(v.failures)}")
        n_pass += v.n_pass
    check(n_pass == 12 and len(verdicts) == 7,
          f"{n_pass} canaries over {len(verdicts)} groups, not 12 over 7")
    for name in GUARD_KERNELS:
        check(launches[name] > 0, f"{name} not launched by the canaries")
    print(f"  conformance: 12 canaries over 7 groups passed in "
          f"{wall_s:.3f} s (wall, first launches of every kernel included)")
    return {"wall_s": wall_s, "verdicts": guard.verdict_table(),
            "launches": {k: v for k, v in launches.items() if v}}


# The kernels only the guard's canaries run (PERF.md rows 6, 7, 10, 11):
# name → (source, the TPU kernel it replaces).
GUARD_KERNELS = {
    "sce_bucket_fwd": ("sce_gather.cu", "sce_bucket.py:40"),
    "sce_bucket_dx": ("sce_gather.cu", "sce_bucket.py:160"),
    "sce_bucket_dy": ("sce_gather.cu", "sce_bucket.py:209"),
    "sce_bucket_plse_fwd": ("sce_gather.cu", "sce_bucket.py:108"),
    "eval_topk": ("eval_fused.cu", "eval_topk.py:57"),
    "eval_tgt_scores": ("eval_fused.cu", "eval_topk.py:121"),
}


def bucket_case(name, x_b, y_b, tgt, cand, pos, cap=None):
    """The sce_bucket kernels (forward, dX, dY, and the partial LSE with
    the same dX and dY launches) against autograd through the plain
    versions on one input; dY must repeat bit for bit. Returns the case's
    max errors; raises on disagreement."""
    import torch

    from repro_torch.kernels import ref, sce_bucket

    g = torch.rand(pos.shape, device=pos.device,
                   generator=torch.Generator(device=pos.device).manual_seed(7))
    errs = {}

    def hold(what, a, b, rtol):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{name}: {what} shape or finiteness")
        err = (a - b).abs()
        tol = 1e-5 * b.abs().max().item()
        check(bool((err <= tol + rtol * b.abs()).all()),
              f"{name}: {what} differs by {err.max().item():.3e} "
              f"(tol {tol:.3e} + {rtol}·|want|)")
        errs[what] = err.max().item()

    got_l = [t.clone().requires_grad_(True) for t in (x_b, y_b, pos)]
    loss = sce_bucket.sce_bucket_loss(got_l[0], got_l[1], tgt, cand,
                                      got_l[2], logit_softcap=cap)
    got = [loss.detach()] + list(torch.autograd.grad((loss * g).sum(), got_l))
    want_l = [t.clone().requires_grad_(True) for t in (x_b, y_b, pos)]
    wloss = ref.sce_bucket_loss_ref(want_l[0], want_l[1], tgt, cand,
                                    want_l[2], cap)
    want = [wloss.detach()] + list(torch.autograd.grad((wloss * g).sum(),
                                                       want_l))
    torch.cuda.synchronize()
    for what, a, b, rtol in zip(("loss", "dx", "dy", "dpos"), got, want,
                                (0.0, 2e-4, 2e-4, 2e-4)):
        hold(what, a, b, rtol)
    check(bool((got[2][cand < 0] == 0).all()),
          f"{name}: a masked candidate's dY row is not exactly 0")
    _, lse = sce_bucket.sce_bucket_fwd(x_b, y_b, tgt, cand, pos,
                                       logit_softcap=cap)
    d1 = sce_bucket.sce_bucket_dy(x_b, y_b, tgt, cand, lse, g,
                                  logit_softcap=cap)
    d2 = sce_bucket.sce_bucket_dy(x_b, y_b, tgt, cand, lse, g,
                                  logit_softcap=cap)
    check(torch.equal(d1, d2), f"{name}: two dY launches differ")
    got_l = [t.clone().requires_grad_(True) for t in (x_b, y_b)]
    plse = sce_bucket.sce_bucket_plse(got_l[0], got_l[1], tgt, cand,
                                      logit_softcap=cap)
    got = [plse.detach()] + list(torch.autograd.grad((plse * g).sum(), got_l))
    want_l = [t.clone().requires_grad_(True) for t in (x_b, y_b)]
    wplse = ref.sce_bucket_plse_ref(want_l[0], want_l[1], tgt, cand, cap)
    want = [wplse.detach()] + list(torch.autograd.grad((wplse * g).sum(),
                                                       want_l))
    torch.cuda.synchronize()
    for what, a, b, rtol in zip(("plse", "plse_dx", "plse_dy"), got, want,
                                (0.0, 2e-4, 2e-4)):
        hold(what, a, b, rtol)
    n_b, b_x, d = x_b.shape
    print(f"  case {name}: n_b={n_b} b_x={b_x} b_y={y_b.shape[1]} d={d} "
          f"cap={cap} max err " + " ".join(f"{k} {v:.3e}"
                                          for k, v in errs.items())
          + "; dY bit-equal across two launches ok")
    return {"name": name, "n_b": n_b, "b_x": b_x, "b_y": y_b.shape[1],
            "d": d, "cap": cap, "max_abs_err": errs,
            "dy_bitwise_repeat": True}


def bucket_bounds(x_b, y_b, tgt, cand):
    """Least times on these inputs, as :func:`gather_bounds`: each launch
    reads x_b, the pre-gathered y_b, the ids and its per-row inputs once
    and writes its outputs once; the forward does 2·n_b·b_x·b_y·d f32
    FLOPs, dX and dY twice that in 3xTF32 with an exp per unmasked
    pair."""
    n_b, b_x, d = x_b.shape
    b_y = y_b.shape[1]
    common = 4 * (n_b * b_x * d + n_b * b_y * d + n_b * b_y + n_b * b_x)
    flops = 2 * n_b * b_x * b_y * d
    exps = unmasked_pairs(tgt, cand)
    return {
        "sce_bucket_fwd": f32_bound(common + 4 * 3 * n_b * b_x, flops),
        "sce_bucket_plse_fwd": f32_bound(common + 4 * n_b * b_x, flops),
        "sce_bucket_dx": tf32x3_bound(
            common + 4 * 2 * n_b * b_x + 4 * n_b * b_x * d, 2 * flops, exps),
        "sce_bucket_dy": tf32x3_bound(
            common + 4 * 2 * n_b * b_x + 4 * n_b * b_y * d, 2 * flops, exps),
    }


def topk_case(name, x, y, t, k, *, c_lo, c_hi, id_offset=0):
    """``eval_tgt_scores`` then ``eval_topk`` against the plain versions
    on one input; the threshold must be bit for bit the swept column
    (``eq >= 1`` on every valid target). Raises on disagreement."""
    import torch

    from repro_torch.kernels import eval_topk as tk
    from repro_torch.kernels import ref

    ts = tk.eval_tgt_scores(x, y, t, id_offset=id_offset)
    vals, ids, gt, eq = tk.eval_topk(x, y, ts, k, c_lo=c_lo, c_hi=c_hi,
                                     id_offset=id_offset)
    torch.cuda.synchronize()
    ts_want = ref.eval_tgt_scores_ref(x, y, t, id_offset=id_offset)
    want = ref.eval_topk_ref(x, y, ts_want, k, c_lo=c_lo, c_hi=c_hi,
                             id_offset=id_offset)
    gid = id_offset + torch.arange(y.shape[0], device=x.device)
    ok = (gid >= c_lo) & (gid < c_hi)
    s64 = x.double() @ y.double().T
    scale = s64[:, ok].abs().max().item()
    tol = 1e-5 * scale
    ts_err = (ts - ts_want).abs().max().item()
    err = (vals - want[0]).abs().max().item()
    check(ts_err <= tol, f"{name}: tgt_scores differ by {ts_err} > {tol}")
    check(err <= tol, f"{name}: values differ by {err} > {tol}")
    t64 = ts.double()[:, None]
    lo = ((s64 > t64 + tol) & ok[None, :]).sum(1)
    hi = ((s64 >= t64 - tol) & ok[None, :]).sum(1)
    check(bool(((gt >= lo) & (gt + eq <= hi)).all()),
          f"{name}: gt/eq outside the f64 band")
    top = torch.topk(torch.where(ok[None, :], s64, NEG_INF),
                     min(k + 1, y.shape[0]), dim=1).values
    if top.shape[1] == k:
        top = torch.cat([top, torch.full_like(top[:, :1], NEG_INF)], 1)
    gap = 1e-4 * scale
    prv = torch.cat([torch.full_like(top[:, :1], float("inf")),
                     top[:, :k - 1]], 1)
    isolated = ((prv - top[:, :k]) > gap) & ((top[:, :k] - top[:, 1:]) > gap)
    check(bool((ids == want[1])[isolated].all()),
          f"{name}: isolated ids differ from the plain version")
    valid_t = (t >= max(c_lo, id_offset)) & (t < min(c_hi, id_offset
                                                     + y.shape[0]))
    check(bool((eq[valid_t] >= 1).all()),
          f"{name}: eval_tgt_scores is not bitwise eval_topk's column")
    hit = ids == t[:, None]
    check(torch.equal(vals[hit], ts[:, None].expand(-1, k)[hit]),
          f"{name}: a target in the top-k does not carry its score exactly")
    print(f"  case {name}: B={x.shape[0]} C={y.shape[0]} k={k} window "
          f"[{c_lo}, {c_hi}) id_offset={id_offset} max_abs_err vals "
          f"{err:.3e} tgt_scores {ts_err:.3e} (tol {tol:.3e}); eq >= 1 on "
          f"{int(valid_t.sum())} valid targets (bitwise column) ok")
    return {"name": name, "B": x.shape[0], "C": y.shape[0], "k": k,
            "max_abs_err": err, "tgt_err": ts_err, "tol": tol,
            "bitwise_column_rows": int(valid_t.sum())}


def guard_kernel_phase(dev):
    """Rows 6, 7, 10 and 11 against their plain versions at the
    full-width shapes, then their times with a cold L2."""
    import torch

    from repro_torch.kernels import eval_topk as tk
    from repro_torch.kernels import ref, sce_bucket

    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    # The training shape with y_b gathered from the catalog: each bucket
    # 256 distinct catalog rows, a collision in slot 0 and a padding slot.
    x = randn(N_POS, D)
    y = randn(C_SERVE, D, scale=0.125)
    targets = torch.randint(1, N_ITEMS, (N_POS,), generator=g, device=dev,
                            dtype=torch.int32)
    idx_x = torch.stack([torch.randperm(N_POS, generator=g,
                                        device=dev)[:B_X]
                         for _ in range(N_B)])
    idx_y = torch.stack([torch.randperm(C_SERVE, generator=g,
                                        device=dev)[:B_Y]
                         for _ in range(N_B)]).to(torch.int32)
    x_b = x[idx_x].contiguous()
    tgt_b = targets[idx_x].contiguous()
    y_b = y[idx_y.long()].contiguous()
    cand = idx_y.clone()
    cand[:, 0] = tgt_b[:, 0]
    cand[:, -1] = -1
    pos = torch.einsum("nxd,nxd->nx", x_b, y[tgt_b.long()]).contiguous()
    bcases = [bucket_case("bucket_train_shape", x_b, y_b, tgt_b, cand, pos)]
    pos30 = (30.0 * torch.tanh(pos * 8.0 / 30.0)).contiguous()
    bcases.append(bucket_case("bucket_train_shape_cap30", x_b * 8.0, y_b,
                              tgt_b, cand, pos30, cap=30.0))

    # The two-pass evaluation at the evaluation's shapes.
    ye = randn(C_SERVE, D, scale=0.02)
    window = dict(c_lo=1, c_hi=N_ITEMS)
    inputs = {}
    for b in EVAL_B:
        xe = randn(b, D)
        te = torch.randint(1, N_ITEMS, (b,), generator=g, device=dev,
                           dtype=torch.int32)
        ye[te[:8].long()] = 0.05 * xe[:8]
        inputs[b] = (xe, te)
    tcases = [topk_case(f"two_pass_b{b}", inputs[b][0], ye, inputs[b][1], K,
                        **window) for b in EVAL_B]
    c_l = C_SERVE // SHARDS
    xo, to = randn(64, D), torch.randint(c_l - 500, 2 * c_l + 500, (64,),
                                         generator=g, device=dev,
                                         dtype=torch.int32)
    tcases.append(topk_case("two_pass_shard1_offset", xo, ye[c_l:2 * c_l],
                            to, K, c_lo=c_l, c_hi=2 * c_l, id_offset=c_l))

    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    g_up = torch.rand(pos.shape, generator=g, device=dev)
    _, lse = sce_bucket.sce_bucket_fwd(x_b, y_b, tgt_b, cand, pos)
    probs = torch.rand(N_B, B_X, B_Y, generator=g, device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (x_b, y_b)]
    out = (ref.sce_bucket_loss_ref(leaves[0], leaves[1], tgt_b, cand, pos)
           * g_up).sum()
    pleaves = [t.clone().requires_grad_(True) for t in (x_b, y_b)]
    args = (x_b, y_b, tgt_b, cand)
    bias = torch.where((cand[:, None, :] < 0)
                       | (cand[:, None, :] == tgt_b[:, :, None]),
                       NEG_INF, 0.0)
    runs = {
        "sce_bucket_fwd": (
            lambda: sce_bucket.sce_bucket_fwd(*args, pos),
            lambda: ref.sce_bucket_loss_ref(*args, pos),
            lambda: torch.bmm(x_b, y_b.transpose(1, 2))),
        "sce_bucket_dx": (
            lambda: sce_bucket.sce_bucket_dx(*args, lse, g_up),
            lambda: torch.autograd.grad(out, leaves[0], retain_graph=True),
            lambda: torch.bmm(probs, y_b)),
        "sce_bucket_dy": (
            lambda: sce_bucket.sce_bucket_dy(*args, lse, g_up),
            lambda: torch.autograd.grad(out, leaves[1], retain_graph=True),
            lambda: torch.bmm(probs.transpose(1, 2), x_b)),
        "sce_bucket_plse_fwd": (
            lambda: sce_bucket.sce_bucket_plse_fwd(*args),
            lambda: ref.sce_bucket_plse_ref(pleaves[0], pleaves[1], tgt_b,
                                            cand),
            lambda: torch.logsumexp(torch.baddbmm(
                bias, x_b, y_b.transpose(1, 2)), dim=-1)),
    }
    bounds = bucket_bounds(x_b, y_b, tgt_b, cand)
    window_mask = (torch.arange(C_SERVE, device=dev) >= 1) & \
        (torch.arange(C_SERVE, device=dev) < N_ITEMS)
    for b in EVAL_B:
        xe, te = inputs[b]
        ts = tk.eval_tgt_scores(xe, ye, te)
        sfx = "" if b == EVAL_B[1] else f"_b{b}"

        def library(xe=xe, ts=ts):
            s_ = torch.where(window_mask[None, :], torch.matmul(xe, ye.T),
                             NEG_INF)
            return (torch.topk(s_, K), (s_ > ts[:, None]).sum(1),
                    (s_ == ts[:, None]).sum(1))

        runs[f"eval_topk{sfx}"] = (
            lambda xe=xe, ts=ts: tk.eval_topk(xe, ye, ts, K, **window),
            lambda xe=xe, ts=ts: ref.eval_topk_ref(xe, ye, ts, K, **window),
            library)
        runs[f"eval_tgt_scores{sfx}"] = (
            lambda xe=xe, te=te: tk.eval_tgt_scores(xe, ye, te),
            lambda xe=xe, te=te: ref.eval_tgt_scores_ref(xe, ye, te),
            lambda xe=xe, te=te: (xe * ye[te.long()]).sum(-1))
        fused, gather = eval_bounds(b, C_SERVE, D, K,
                                    int(torch.unique(te).numel()))
        bounds[f"eval_topk{sfx}"] = fused
        bounds[f"eval_tgt_scores{sfx}"] = gather
    timings = {}
    with torch.no_grad():
        for name, (kern, plain, lib) in runs.items():
            heavy = name.startswith("eval_topk")
            timings[name] = {"ms": time_ms(kern, 20, flush),
                             "plain_ms": time_ms(plain, 2 if heavy else 5,
                                                 flush),
                             "library_ms": time_ms(lib, 20, flush),
                             **bound_keys(bounds[name])}
    for name, t in timings.items():
        print(f"  time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {bound_text(t)}")
    return bcases, tcases, timings


# ---------------------------------------------------------------------------
# Drills: the divergence guard and a broken kernel
# ---------------------------------------------------------------------------
CHAOS_AT = 5


def drill_phase(dev):
    """The divergence drill at full width (NaN params at step 5: strikes
    at steps 5 and 6, the RuntimeError at step 7, each strike line naming
    the sentinel) and the broken-kernel drill (a ``mips_topk`` that
    raises: under ``warn`` its CUDA dispatch raises
    ``KernelConformanceError``, and a fresh server stays not ready)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.kernels import guard, ops
    from repro_torch.kernels import mips_topk as mips_mod
    from repro_torch.launch.serve import RetrievalServer, ServerNotReadyError
    from repro_torch.launch.train import train

    cfg = make_config()
    buf = io.StringIO()
    raised = None
    with contextlib.redirect_stdout(buf):
        try:
            train("sasrec-sce", cfg=cfg, batch=N_POS // cfg.max_len,
                  steps=CHAOS_AT + 6, seed=0, log_every=0, device=dev,
                  chaos_nan_at=CHAOS_AT, guard_policy="strict")
        except RuntimeError as e:  # the drill's expected outcome
            raised = e
    guard.set_policy(None)
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  | {line}")
    check(raised is not None, "the divergence drill did not raise")
    check(f"at step {CHAOS_AT + 2} and no --ckpt-dir" in str(raised),
          f"the divergence drill raised {raised!r}")
    strikes = [ln for ln in lines if ln.startswith("[guard] step")]
    check(len(strikes) == 3 and all(
        ln.startswith(f"[guard] step {CHAOS_AT + i}: loss nan")
        and f"(strike {i + 1}/3)" in ln and "sce_bucket_nonfinite" in ln
        for i, ln in enumerate(strikes)), f"strike lines {strikes}")
    print(f"  divergence drill: RuntimeError({raised}) after 3 strike lines "
          f"naming sce_bucket_nonfinite ok")

    def broken(*a, **k):
        raise RuntimeError("injected miscompile")

    real = mips_mod.mips_topk
    mips_mod.mips_topk = broken
    guard.clear_verdicts("mips_topk")
    guard.set_policy("warn")
    try:
        q = torch.randn(8, D, device=dev)
        err = None
        try:
            ops.mips_topk(q, torch.randn(1_000, D, device=dev), K)
        except guard.KernelConformanceError as e:  # the drill's outcome
            err = e
        check(err is not None and err.kernel == "mips_topk",
              "a broken mips_topk did not raise under warn")
        server = RetrievalServer("sasrec-sce", buckets=(8,), top_k=K,
                                 device=dev)
        try:
            not_ready = None
            try:
                server.submit(np.ones(server.cfg.max_len, np.int32))
            except ServerNotReadyError as e:  # the drill's outcome
                not_ready = e
            check(not server.ready and not_ready is not None
                  and "mips_topk" in (server.readiness_error or ""),
                  "a server on a broken mips_topk became ready")
            health = server.health()
        finally:
            server.close()
    finally:
        mips_mod.mips_topk = real
        guard.clear_verdicts("mips_topk")
        guard.set_policy(None)
    check(guard.verdict_for("mips_topk", device=dev).passed,
          "mips_topk fails its canaries after the drill")
    print(f"  broken-kernel drill: KernelConformanceError under warn "
          f"({str(err)[:80]}...); fresh server not ready "
          f"(ready={health['ready']}, readiness_error set) ok")
    return {"divergence_error": str(raised), "strike_lines": strikes,
            "broken_kernel_error": str(err),
            "server_ready": health["ready"],
            "readiness_error": health["readiness_error"]}


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
    print(f"[1/{N_PHASES}] device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")

    t0 = time.monotonic()
    libs = _build.build_all()
    build_s = time.monotonic() - t0
    print(f"[2/{N_PHASES}] build: {len(libs)} kernel libraries in "
          f"{build_s:.2f} s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    def phase(i, what):
        print(f"[{i}/{N_PHASES}] {what}:")

    phase(3, "kernel guard: every conformance canary on the card")
    conformance = conformance_phase(dev)
    phase(4, "serve kernel against its plain version")
    cases, timings = kernel_phase(dev)
    phase(5, "server at full width")
    server = server_phase(dev)
    phase(6, "train kernels against their plain versions")
    tcases, gcases, pcases, ttimes = train_kernel_phase(dev)
    phase(7, "trainer at full width, sce_mode=gspmd")
    trainer = train_phase(dev, "gspmd")
    phase(8, "trainer at full width, its default sce_mode=exact, guard "
             "strict, its verdicts run at first dispatch")
    exact = train_phase(dev, "exact", guard_policy="strict",
                        fresh=("mips_topk", "sce_gather", "eval_fused"))
    phase(9, "the same trainer with the guard off")
    exact_off = train_phase(dev, "exact", guard_policy="off")
    phase(10, "one batch through the three SCE modes")
    agreement = mode_agreement_phase(dev)
    phase(11, "eval kernels against their plain versions")
    ecases, etimes = eval_kernel_phase(dev)
    phase(12, "evaluation at full width")
    evaluation = eval_phase(dev)
    phase(13, "full-CE kernels against their plain versions")
    ccases, ctimes = ce_kernel_phase(dev)
    phase(14, "trainer with the competitor losses at full width")
    competitors = loss_phase(dev, (trainer, exact))
    phase(15, "guard kernels (sce_bucket, eval_topk) against their plain "
              "versions")
    bcases, tkcases, gtimes = guard_kernel_phase(dev)
    phase(16, "drills: divergence, broken kernel")
    drills = drill_phase(dev)

    t = timings[512]  # the serve_p99 bucket
    mips = {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mips_topk.cu",
            "replaces": "src/repro/kernels/mips_topk.py:52"}
    trainers = (trainer, exact)
    kernels = [{
        "name": "mips_topk",
        **mips,
        # serving's launches and both trainers', each path counted from 0
        "launches": server["launches"] + sum(
            r["launches"]["mips_topk"] for r in trainers),
        "max_abs_err": max([timings[b]["max_abs_err"] for b in BUCKETS]
                           + [c["max_abs_err"] for c in tcases]),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]
    # The same kernel at training's two selections, with the launches both
    # trainers made at that k.
    for name, k in (("positions_k320", B_X), ("catalog_k256", B_Y)):
        tt = ttimes[name]
        kernels.append({
            "name": f"mips_topk_train_{name}",
            **mips,
            "launches": sum(r["mips_topk_launches_by_k"][k]
                            for r in trainers),
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
    for name, what in zip(PLSE, ("plse", "dx", "dy")):
        tt = ttimes[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sce_gather.cu",
            "replaces": "src/repro/kernels/sce_prefetch.py:497",
            "launches": exact["launches"][name],
            "max_abs_err": max(c["max_abs_err"][what] for c in pcases),
            "ms": tt["ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"],
            "bound_by": tt["bound_by"],
            "library_ms": tt["library_ms"],
        })
    for name, line in (("eval_fused", 104), ("eval_tgt_gather", 82)):
        for b, launches in ((EVAL_B[1], evaluation["launches"][name]),
                            (EVAL_B[0], sum(r["launches"][name]
                                            for r in trainers))):
            tt = etimes[b][name]
            err = max(c["max_abs_err" if name == "eval_fused" else "tgt_err"]
                      for c in ecases)
            kernels.append({
                "name": name if b == EVAL_B[1] else f"{name}_b{b}",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/eval_fused.cu",
                "replaces": f"src/repro/kernels/eval_fused.py:{line}",
                "launches": launches,
                "max_abs_err": err,
                "ms": tt["ms"],
                "plain_ms": tt["plain_ms"],
                "bound_ms": tt["bound_ms"],
                "bound_by": tt["bound_by"],
                "library_ms": tt["library_ms"],
            })
    for name, (src, replaces) in GUARD_KERNELS.items():
        bcase_err = {"sce_bucket_fwd": "loss", "sce_bucket_dx": "dx",
                     "sce_bucket_dy": "dy", "sce_bucket_plse_fwd": "plse"}
        if name in bcase_err:
            err = max(c["max_abs_err"][bcase_err[name]] for c in bcases)
        else:
            err = max(c["max_abs_err" if name == "eval_topk" else "tgt_err"]
                      for c in tkcases)
        tt = gtimes[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            # the conformance phase is the path that runs these
            "launches": conformance["launches"][name],
            "max_abs_err": err,
            "ms": tt["ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"],
            "bound_by": tt["bound_by"],
            "library_ms": tt["library_ms"],
        })
    # the split is a prologue of the port's own backward: no TPU kernel
    for kname, _, _, replaces in CE_KERNELS + (
            ("linear_ce_split", "linear", "split", None),):
        tt = ctimes[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/linear_ce.cu",
            "replaces": replaces,
            "launches": competitors["launches"][kname],
            "max_abs_err": max(c["max_abs_err"][kname] for c in ccases),
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
            "plse_cases": pcases, "train_timings": ttimes,
            "trainer": trainer, "trainer_exact": exact,
            "mode_agreement": agreement,
            "eval_cases": ecases,
            "eval_timings": {str(b): v for b, v in etimes.items()},
            "evaluation": evaluation, "ce_cases": ccases,
            "ce_timings": ctimes, "competitor_losses": competitors,
            "conformance": conformance, "trainer_exact_guard_off": exact_off,
            "bucket_cases": bcases, "two_pass_cases": tkcases,
            "guard_timings": gtimes, "drills": drills,
            "kernels": kernels,
        }, indent=1))
    print(f"[{N_PHASES}/{N_PHASES}] summary")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
