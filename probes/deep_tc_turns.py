#!/usr/bin/env python3
"""The deep variants (d > 256) of two trees on the card: their outputs bit
for bit, their times in turns, and a clock profile of their product by
phase. Needs an NVIDIA GPU.

    python3 probes/deep_tc_turns.py digests TREE LABEL
    python3 probes/deep_tc_turns.py times TREE LABEL
    python3 probes/deep_tc_turns.py profile TREE LABEL [bf16|slab|sweep]
    python3 probes/deep_tc_turns.py slab TREE LABEL [--plain] [NAME ...]
    python3 probes/deep_tc_turns.py sweep TREE LABEL
    python3 probes/deep_tc_turns.py plans TREE LABEL

imports ``repro_torch`` (and ``chip_smoke.py``) from ``TREE`` — a checkout
of any commit, for example the parent unpacked with ``git archive`` into
``.benchrun/`` — builds its kernels and prints ``LABEL {...}``, at
gemma-2-2b's LM shapes (d 2304, vocabulary 256,000; SCE n_b 128,
b_x 128, b_y 1024, cap 30; inputs from fixed seeds on the card: x and the
centres at unit scale, the table at 0.02):

* ``digests``: a SHA-256 (16 hex digits) of every deep output — the SCE
  loss's forward, dX and dY, the partial LSE's forward and its one-launch
  backward (dX and dY from one cotangent), the bucket twins' forward, dX
  and dY; ``mips_topk`` over 4,096 positions at k 128 and over the
  vocabulary at k 1024 and k 10 (``mips_topk_k10``, the deep sweep);
  ``eval_fused`` at 8,192 × 256,000, k 1 with the LSE and cap 30 (its
  ranks, target and values, then ``eval_fused_lse`` its (m, s) apart),
  with ``eval_tgt_gather``; ``eval_topk`` (the two-pass
  sweep) at 512 × 256,000, k 10; the deep ``linear_ce`` forward (cap 30,
  the target plucked) and its one-launch backward at 4,096 × 256,000.
  Equal digests in two trees are equal bits. Where the tree takes
  bfloat16 operands, ``bf16`` holds, for the same inputs rounded to bf16,
  each deep output's digest, whether it equals the f32 launch on the
  widened inputs bit for bit and whether a second launch repeats it:
  the selections, ``eval_fused``, ``eval_topk`` (512 rows, k 10) and
  ``eval_tgt_gather`` (the score
  slab: in older trees one TF32 pass, equal; on ``gemm_bf16``, not),
  the partial LSE's forward and its one-launch
  backward, the loss's forward, dX and dY, the bucket twins', the
  ``linear_ce`` forward and its one-launch backward (``eval_slab`` /
  ``eval_slab_bf16``: one eval slab of 1,024 rows, ``score_slab``;
  ``mips_topk_k10``:
  the deep sweep at k 10 over the vocabulary; ``eval_fused`` with
  ``digest_ranks`` and ``digest_lse`` apart); and ``dy_sum``, the
  in-order dY sum of one f32 workspace into the bf16 table (a tree
  whose sum writes f32 only: its f32 table rounded to bf16), whose equal
  digests show the sum's order unchanged; ``targets_are_slab_columns``
  (a tree with ``eval_fused.score_slab``): every bf16
  ``eval_tgt_gather`` and ``eval_tgt_scores`` score at 8,192 ×
  256,000 equal to its eval slab's column bit for bit; a tree that
  refuses bf16 prints ``"refused"``.
* ``times``: device ms (CUDA events, the mean of 5 calls, each after a
  1 GiB L2 flush) of ``sce_gather_plse_fwd``, the partial LSE's backward
  as autograd runs it (``sce_prefetch._grads``: logits, cotangent, dX,
  dY's slot rows, the in-order dY sum), ``sce_gather_fwd``, the deep
  ``mips_topk`` at k 128 over the 4,096 positions and at k 1024 over the
  vocabulary, and ``eval_fused`` at 8,192 × 256,000 (k 1, the LSE, cap
  30; 3 calls); that backward and both ``mips_topk`` calls split by
  kernel in launch order (``torch.profiler``, one warm call). Where the
  tree takes bf16 (``bf16``): the same SCE calls on bf16 x_b and y, the
  partial LSE's dY wrapper alone (logits, cotangent, slot rows, keys and
  sort, zeroing, the in-order sum), the sum alone into the bf16 table
  (the f32 sum and its cast in a tree without one), the deep
  ``linear_ce`` forward and one-launch backward at 4,096 × 256,000 (cap
  30, plucked; 2 calls), and the bf16 backward split by kernel.
* ``profile``: the tree's depth-chunked product (``csrc/deep_tc.cuh``,
  its element-typed kernel) built from a copy with ``clock64()`` read
  around each phase of its depth loop (summed per warp, read back
  through an added ``extern "C"`` getter), for each of the deep
  backward's three products (the logits alone from the forward; dX and
  dY alone, less the logits): each phase's share of the warps' cycles
  and the cycles a warp spends per 32-deep chunk: prologue, ``wait``
  (``cp.async`` wait and the barrier), ``issue`` (each k16 step's six
  ``wgmma``, then half of chunk t + 1's split while the tensor cores
  run), ``copies`` (chunk t + 3's), ``drain`` (waiting for the
  ``wgmma``), ``add`` (the k16 products into the accumulator),
  epilogue.
  ``cycles_per_warp_chunk`` counts the loop's phases only; at the dense
  495 TFLOP/s of TF32 a chunk's three passes of a 128 × 128 × 32 tile
  take ≈ 1,660 cycles of an SM.
  With ``bf16`` (a tree with ``deep_tc.cuh``'s ``gemm_bf16``): the bf16
  product's phases on bf16 operands, per warp role — the consumer
  warpgroups' ``wait`` (the stage's full barrier), ``issue`` (four
  ``wgmma`` and the commit), ``drain`` (``wgmma`` wait for the stage
  before, freeing it), ``epilogue`` (the tile's last wait and its f32
  stores); the producer warpgroup's ``empty`` (waiting for a free stage)
  and ``copy`` (TMA issue, gathered or register-staged copies) — and
  the consumers' cycles per 64-deep stage; at the dense 989 TFLOP/s a
  stage of a 128 × 128 × 64 tile takes ≈ 510 cycles of an SM.
  With ``slab``: the product the tree's bf16 score slab runs (the
  one-TF32 ``gemm`` or ``gemm_bf16``, whichever ``score_slab`` calls),
  profiled the same way in the bf16 selections and eval of ``slab``
  below (a getter added to ``mips_topk.cu`` and ``eval_fused.cu``).
  With ``sweep``: the deep eval sweep that reads the score slab
  (``topk_tile.cuh``'s ``FROM_S`` in ``eval_fused.cu``'s
  ``eval_sweep_kernel``), from a copy of the tree's header and
  ``eval_fused.cu`` with ``clock64()`` marks (picked by what the header
  holds: the scalar slab loads, or the ring of TMA boxes), on one slab
  of 1,024 rows against the vocabulary, for ``eval_fused`` (the LSE, cap
  30) and ``eval_topk`` on bf16 and f32 operands: each phase's share of
  the warps' cycles — ``sync`` (the per-tile barrier, the next tile's
  flags and, with the ring, its copies' issue), ``tau``, ``merge``,
  ``loads`` (the wait for the tile's scores: the scalar loads, or the
  stage's mbarrier), ``reads`` (the ring's LDS.64), ``hook``, ``filter``,
  ``tail``, ``prologue`` — the hook's own split (``counts``, ``tanh``,
  ``max``, ``exps``: each phase's results used before its clock) and the
  cycles a warp spends on a tile.
* ``sweep``: the deep eval sweep of the tree: ``eval_fused`` (k 1, the
  LSE, cap 30) and ``eval_topk`` (k 1) at 8,192 × 256,000 on bf16 and f32
  operands (device ms, CUDA events, after a 1 GiB flush; 3 calls bf16, 1
  f32), each split per slab by kind (``torch.profiler``: the slab's
  product, the pre-pass and its τ, the sweep, the merge;
  ``sweep_alone`` their sum), and PyTorch on one given slab (the
  kernels' own, 1,024 rows): ``max(0)``, the counts against the target
  scores and the capped ``logsumexp`` under the window, beside the
  slab's bytes at 3.35 TB/s.
* ``plans``: the deep sweep of one bf16 slab (1,024 rows, the kernels'
  own; ``eval_fused`` with the LSE and ``eval_topk``) alone
  (``torch.profiler``, after the flush) under the tree's plan and under
  others set in its place (``mips_topk.slab_sweep_plan`` patched): 8,
  12, 24 and 33 splits of blocks of 4 query tiles (33: two whole waves
  at 4 an SM), 16 without the pre-pass, and blocks of 1 query tile
  (32-byte rows) in 4 splits. For a tree with ``slab_sweep_plan``.
* ``slab``: the bf16 score slab apart from its readers — ``mips_topk``
  at 128 × 4,096, k 128 and at 128 × 256,000, k 1024, ``eval_fused``
  at 8,192 × 256,000, k 1 with the LSE and cap 30 (8 slabs of 1,024
  rows; the target given), ``eval_topk`` at the same shape, k 1, and
  ``eval_tgt_gather`` / ``eval_tgt_scores`` at 8,192 rows, on bf16
  operands: the call's device ms (CUDA events, each after a 1 GiB L2
  flush) beside a PyTorch call of the same function on the same bf16
  tensors, the bound (``chip_smoke.bf16_bound``) and, with ``--plain``,
  the plain version (``kernels/ref.py``), and each kernel's device ms
  in
  launch order (``torch.profiler``, the flush queued first in the same
  trace, so every call starts from a cold L2), summed into ``slab`` (the
  product), ``readers`` (the sweeps, chains, counts, folds and merges),
  ``target`` (``eval_tgt_gather``) and ``other``. ``NAME``s (say
  ``mips_topk_k128``) keep only those calls.

Every line carries ``nvidia-smi``'s card name and power limit. Run two
trees in turns (parent, change, change, parent) in one call to compare
times.
"""
import hashlib
import json
import os
import re
import shutil
import sys
import tempfile
from pathlib import Path

N_B, B_X, B_Y, C, D, N_POS, N_EVAL = 128, 128, 1024, 256_000, 2304, 4096, 8192
CAP = 30.0


def _digest(*tensors):
    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:  # its bits (numpy has no bf16)
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _setup(tree):
    sys.path.insert(0, str(Path(tree) / "src"))
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from repro_torch import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    _build.build_all()
    g = torch.Generator(device=dev).manual_seed(25)
    y = torch.randn(C, D, generator=g, device=dev) * 0.02
    x_b = torch.randn(N_B, B_X, D, generator=g, device=dev)
    idx = torch.randint(0, C, (N_B, B_Y), generator=g, device=dev,
                        dtype=torch.int32)
    tgt = torch.randint(0, C, (N_B, B_X), generator=g, device=dev,
                        dtype=torch.int32)
    cand = idx.clone()
    cand[:, 0] = tgt[:, 0]
    cand[:, -1] = -1
    pos = CAP * torch.tanh(torch.randn(N_B, B_X, generator=g, device=dev))
    gg = torch.rand(N_B, B_X, generator=g, device=dev)
    return torch, chip_smoke, dev, g, (x_b, y, idx, tgt, cand), pos, gg


def digests(tree, label):
    torch, cs, dev, g, args, pos, gg = _setup(tree)
    from repro_torch.kernels import eval_fused, sce_bucket, sce_prefetch
    from repro_torch.kernels.mips_topk import mips_topk

    kw = dict(logit_softcap=CAP)
    out = {}
    loss, lse = sce_prefetch.sce_gather_fwd(*args, pos, **kw)
    out["sce_gather"] = _digest(
        loss, lse, sce_prefetch.sce_gather_dx(*args, lse, gg, **kw),
        sce_prefetch.sce_gather_dy(*args, lse, gg, **kw))
    plse = sce_prefetch.sce_gather_plse_fwd(*args, **kw)
    out["sce_gather_plse"] = _digest(plse, *sce_prefetch._grads(
        sce_prefetch.sce_gather_plse_dx, sce_prefetch.sce_gather_plse_dy,
        args + (plse, gg), CAP, True, True))
    x_b, y, idx, tgt, cand = args
    y_b = y[idx.long()]
    bl, blse = sce_bucket.sce_bucket_fwd(x_b, y_b, tgt, cand, pos, **kw)
    bargs = (x_b, y_b, tgt, cand, blse, gg)
    out["sce_bucket"] = _digest(bl, blse,
                                sce_bucket.sce_bucket_dx(*bargs, **kw),
                                sce_bucket.sce_bucket_dy(*bargs, **kw))
    del y_b, bargs
    q = torch.randn(N_B, D, generator=g, device=dev)
    xs = torch.randn(N_POS, D, generator=g, device=dev)
    out["mips_topk_k128"] = _digest(*mips_topk(q, xs, 128))
    out["mips_topk_k1024"] = _digest(*mips_topk(q, y, 1024))
    xe = torch.randn(N_EVAL, D, generator=g, device=dev)
    te = torch.randint(1, C, (N_EVAL,), generator=g, device=dev,
                       dtype=torch.int32)
    out["mips_topk_k10"] = _digest(*mips_topk(q, y, 10))
    ev = eval_fused.eval_fused(xe, y, te, 1, c_lo=1, c_hi=C,
                               logit_softcap=CAP, with_lse=True)
    out["eval_fused"] = _digest(*ev[:5])
    out["eval_fused_lse"] = _digest(*ev[5:])
    del ev
    out["eval_tgt_gather"] = _digest(eval_fused.eval_tgt_gather(xe, y, te))
    if hasattr(eval_fused, "score_slab"):  # one eval slab, f32 and bf16
        out["eval_slab"] = _digest(eval_fused.score_slab(xe[:1024], y))
        out["eval_slab_bf16"] = _digest(eval_fused.score_slab(
            xe[:1024].to(torch.bfloat16), y.to(torch.bfloat16)))
    from repro_torch.kernels import eval_topk, linear_sce

    tgt_s = eval_topk.eval_tgt_scores(xe[:512], y, te[:512])
    out["eval_topk"] = _digest(tgt_s, *eval_topk.eval_topk(
        xe[:512], y, tgt_s, 10, c_lo=1, c_hi=C))
    tl = te[:N_POS].contiguous()
    loss, lse = linear_sce._fwd(xs, y, tl, CAP)
    out["linear_ce"] = _digest(loss, lse, *linear_sce._bwd_deep(
        xs, y, tl, lse, torch.rand(N_POS, generator=g, device=dev) + 0.5,
        CAP, True, True))
    torch.cuda.synchronize()
    out["bf16"] = _bf16_digests(torch, args, q, xs, xe, te, tl)
    print(label, json.dumps({"digests": out, "card": cs.smi()}), flush=True)


def _bf16_digests(torch, args, q, xs, xe, te, tl):
    """For each deep output on bf16 operands: its digest, equal to the f32
    launch on the widened inputs (bool), repeated by a second launch
    (bool); "refused" where the tree takes f32 only."""
    from repro_torch.kernels import (eval_fused, eval_topk, linear_sce,
                                     sce_bucket, sce_prefetch)
    from repro_torch.kernels.mips_topk import mips_topk

    bf = torch.bfloat16
    x_b, y, idx, tgt, cand = args
    xb, yb, qb, xsb, xeb = (t.to(bf) for t in (x_b, y, q, xs, xe))
    w = lambda t: t.float()  # noqa: E731 — the widened copy
    g = torch.Generator(device=x_b.device).manual_seed(26)
    gg = torch.rand(N_B, B_X, generator=g, device=x_b.device)
    pos = CAP * torch.tanh(torch.randn(N_B, B_X, generator=g,
                                       device=x_b.device)).to(bf)
    gr = torch.rand(N_POS, generator=g, device=x_b.device) + 0.5
    kw = dict(logit_softcap=CAP)

    def sce_loss(a, b):
        loss, lse = sce_prefetch.sce_gather_fwd(a, b, idx, tgt, cand,
                                                pos.to(a.dtype), **kw)
        r = (a, b, idx, tgt, cand, lse, gg)
        return (loss, lse, sce_prefetch.sce_gather_dx(*r, **kw),
                sce_prefetch.sce_gather_dy(*r, **kw))

    def plse_pair(a, b):
        plse = sce_prefetch.sce_gather_plse_fwd(a, b, idx, tgt, cand, **kw)
        return (plse,) + tuple(sce_prefetch._grads(
            sce_prefetch.sce_gather_plse_dx, sce_prefetch.sce_gather_plse_dy,
            (a, b, idx, tgt, cand, plse, gg), CAP, True, True))

    def bucket(a, b):
        b_ = b[idx.long()]
        bl, blse = sce_bucket.sce_bucket_fwd(a, b_, tgt, cand,
                                             pos.to(a.dtype), **kw)
        r = (a, b_, tgt, cand, blse, gg)
        return (bl, blse, sce_bucket.sce_bucket_dx(*r, **kw),
                sce_bucket.sce_bucket_dy(*r, **kw))

    def ce(a, b):
        loss, lse = linear_sce._fwd(a, b, tl, CAP)
        return (loss, lse) + tuple(linear_sce._bwd_deep(
            a, b, tl, lse, gr, CAP, True, True))

    pairs = ((xb, yb), (w(xb), w(yb)))
    runs = {
        "mips_topk_k128": (lambda a, b: mips_topk(a, b, 128),
                           ((qb, xsb), (w(qb), w(xsb)))),
        "mips_topk_k1024": (lambda a, b: mips_topk(a, b, 1024),
                            ((qb, yb), (w(qb), w(yb)))),
        "mips_topk_k10": (lambda a, b: mips_topk(a, b, 10),
                          ((qb, yb), (w(qb), w(yb)))),
        "eval_fused": (lambda a, b: eval_fused.eval_fused(
            a, b, te, 1, c_lo=1, c_hi=C, logit_softcap=CAP, with_lse=True),
            ((xeb, yb), (w(xeb), w(yb)))),
        "eval_tgt_gather": (lambda a, b: (eval_fused.eval_tgt_gather(
            a, b, te),), ((xeb, yb), (w(xeb), w(yb)))),
        "eval_topk": (lambda a, b: eval_topk.eval_topk(
            a[:512], b, eval_topk.eval_tgt_scores(a[:512], b, te[:512]), 10,
            c_lo=1, c_hi=C), ((xeb, yb), (w(xeb), w(yb)))),
        "sce_gather_plse": (plse_pair, pairs),
        "sce_gather": (sce_loss, pairs),
        "sce_bucket": (bucket, pairs),
        "linear_ce": (ce, ((xsb, yb), (w(xsb), w(yb)))),
    }
    out = {}
    for name, (fn, (ins, wide)) in runs.items():
        try:
            got = fn(*ins)
        except TypeError:
            return "refused"
        again = fn(*ins)
        want = fn(*wide)
        torch.cuda.synchronize()
        out[name] = {"digest": _digest(*got),
                     "equal_f32_widened": all(
                         torch.equal(a, b.to(a.dtype))
                         for a, b in zip(got, want)),
                     "repeats": all(torch.equal(a, b)
                                    for a, b in zip(got, again))}
        if name == "eval_fused":  # the ranks apart from the LSE pair
            out[name]["digest_ranks"] = _digest(*got[:5])
            out[name]["digest_lse"] = _digest(*got[5:])
        del got, again, want
    ws = torch.randn(N_B * B_Y, D, generator=g, device=x_b.device)
    keys = sce_prefetch.dy_sum_keys(idx, cand, C)
    try:
        table = sce_prefetch.sce_gather_dy_sum(
            ws, *keys, torch.zeros(C, D, device=x_b.device, dtype=bf))
    except TypeError:  # a tree whose sum writes f32 only
        table = sce_prefetch.sce_gather_dy_sum(
            ws, *keys, torch.zeros(C, D, device=x_b.device)).to(bf)
    out["dy_sum"] = {"digest": _digest(table)}
    if hasattr(eval_fused, "score_slab"):  # the eval slab read alone
        tg = eval_fused.eval_tgt_gather(xeb, yb, te)
        ts = eval_topk.eval_tgt_scores(xeb, yb, te)
        same = True
        for r in range(0, N_EVAL, 1024):
            rr = slice(r, r + 1024)
            slab = eval_fused.score_slab(xeb[rr], yb)
            col = slab[te[rr].long(), torch.arange(slab.shape[1],
                                                   device=slab.device)]
            same &= (torch.equal(tg[rr].view(torch.int32),
                                 col.view(torch.int32)) and
                     torch.equal(ts[rr].view(torch.int32),
                                 col.view(torch.int32)))
            del slab, col
        out["targets_are_slab_columns"] = same
    return out


def _kernel_split(torch, fn):
    """Device ms of each kernel ``fn`` launches, in launch order."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if getattr(e, "device_type", None) is not None
           and "CUDA" in str(e.device_type)]
    evs.sort(key=lambda e: e.time_range.start)
    return [(re.sub(r"\(.*", "", e.name.replace("(anonymous namespace)::",
                                                 ""))[:60],
             round(getattr(e, "device_time", 0.0) / 1e3, 4)) for e in evs]


def times(tree, label):
    torch, cs, dev, g, args, pos, gg = _setup(tree)
    from repro_torch.kernels import sce_prefetch

    kw = dict(logit_softcap=CAP)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    plse = sce_prefetch.sce_gather_plse_fwd(*args, **kw)

    def pair():
        return sce_prefetch._grads(
            sce_prefetch.sce_gather_plse_dx, sce_prefetch.sce_gather_plse_dy,
            args + (plse, gg), CAP, True, True)

    from repro_torch.kernels import eval_fused
    from repro_torch.kernels.mips_topk import mips_topk

    y = args[1]
    q = torch.randn(N_B, D, generator=g, device=dev)
    xs = torch.randn(N_POS, D, generator=g, device=dev)
    xe = torch.randn(N_EVAL, D, generator=g, device=dev)
    te = torch.randint(1, C, (N_EVAL,), generator=g, device=dev,
                       dtype=torch.int32)
    runs = {
        "sce_gather_plse_fwd": lambda: sce_prefetch.sce_gather_plse_fwd(
            *args, **kw),
        "sce_gather_plse_bwd": pair,
        "sce_gather_fwd": lambda: sce_prefetch.sce_gather_fwd(*args, pos,
                                                              **kw),
        "mips_topk_k128": lambda: mips_topk(q, xs, 128),
        "mips_topk_k1024": lambda: mips_topk(q, y, 1024),
        "eval_fused": lambda: eval_fused.eval_fused(
            xe, y, te, 1, c_lo=1, c_hi=C, logit_softcap=CAP, with_lse=True),
    }
    with torch.no_grad():
        ms = {k: cs.time_ms(f, 3 if k == "eval_fused" else 5, flush)
              for k, f in runs.items()}
        split = _kernel_split(torch, pair)
        mips_split = {k: _kernel_split(torch, runs[k])
                      for k in ("mips_topk_k128", "mips_topk_k1024")}
    del runs
    bf16 = _bf16_times(torch, cs, args, pos, gg, xs, te, flush)
    print(label, json.dumps({"ms": ms, "bwd_kernels": split,
                             "mips_kernels": mips_split, "bf16": bf16,
                             "card": cs.smi()}), flush=True)


def _bf16_times(torch, cs, args, pos, gg, xs, te, flush):
    """Device ms of the deep SCE and ``linear_ce`` calls on bf16 operands
    (see the module docstring), and the bf16 backward split by kernel;
    "refused" in a tree that takes f32 only."""
    from repro_torch.kernels import linear_sce, sce_prefetch

    bf = torch.bfloat16
    x_b, y, idx, tgt, cand = args
    xb, yb, xsb = x_b.to(bf), y.to(bf), xs.to(bf)
    kw = dict(logit_softcap=CAP)
    try:
        plse = sce_prefetch.sce_gather_plse_fwd(xb, yb, idx, tgt, cand, **kw)
    except TypeError:
        return "refused"
    bargs = (xb, yb, idx, tgt, cand, plse, gg)
    ws = torch.randn(N_B * B_Y, D, device=x_b.device)
    keys = sce_prefetch.dy_sum_keys(idx, cand, C)
    table = torch.zeros(C, D, device=x_b.device, dtype=bf)
    try:
        sce_prefetch.sce_gather_dy_sum(ws, *keys, table)
        dy_sum = lambda: sce_prefetch.sce_gather_dy_sum(  # noqa: E731
            ws, *keys, table)
    except TypeError:  # the f32 sum, then its cast
        table = torch.zeros(C, D, device=x_b.device)
        dy_sum = lambda: sce_prefetch.sce_gather_dy_sum(  # noqa: E731
            ws, *keys, table).to(bf)
    tl = te[:N_POS].contiguous()
    _, lse = linear_sce._fwd(xsb, yb, tl, CAP)
    gr = torch.rand(N_POS, device=x_b.device) + 0.5

    def pair():
        return sce_prefetch._grads(
            sce_prefetch.sce_gather_plse_dx, sce_prefetch.sce_gather_plse_dy,
            bargs, CAP, True, True)

    runs = {
        "sce_gather_plse_fwd": lambda: sce_prefetch.sce_gather_plse_fwd(
            xb, yb, idx, tgt, cand, **kw),
        "sce_gather_plse_bwd": pair,
        "sce_gather_plse_dy": lambda: sce_prefetch.sce_gather_plse_dy(
            *bargs, **kw),
        "sce_gather_dy_sum": dy_sum,
        "sce_gather_fwd": lambda: sce_prefetch.sce_gather_fwd(
            xb, yb, idx, tgt, cand, pos.to(bf), **kw),
        "linear_ce_fwd": lambda: linear_sce._fwd(xsb, yb, tl, CAP),
        "linear_ce_bwd": lambda: linear_sce._bwd_deep(
            xsb, yb, tl, lse, gr, CAP, True, True),
    }
    with torch.no_grad():
        ms = {k: cs.time_ms(f, 2 if k.startswith("linear") else 5, flush)
              for k, f in runs.items()}
        split = _kernel_split(torch, pair)
    return {"ms": ms, "bwd_kernels": split}


def _slab_inputs(torch, dev, g, y, with_library=False):
    """The bf16 selections' and eval's inputs, and their calls (name →
    kernel call); with ``with_library`` name → (kernel call, a PyTorch
    call of the same function on the bf16 tensors, bound args for
    ``chip_smoke.bf16_bound``, the plain version's call)."""
    from repro_torch.kernels import eval_fused, eval_topk, ref
    from repro_torch.kernels.mips_topk import mips_topk

    bf = torch.bfloat16
    q = torch.randn(N_B, D, generator=g, device=dev).to(bf)
    xs = torch.randn(N_POS, D, generator=g, device=dev).to(bf)
    xe = torch.randn(N_EVAL, D, generator=g, device=dev).to(bf)
    te = torch.randint(1, C, (N_EVAL,), generator=g, device=dev,
                       dtype=torch.int32)
    yb = y.to(bf)
    win = torch.arange(C, device=dev) >= 1
    tg = eval_fused.eval_tgt_gather(xe, yb, te)

    def scores():
        return torch.where(win[None, :], (xe @ yb.T).float(), -1e30)

    def lib_eval(lse):
        s_ = scores()
        out = (torch.topk(s_, 1), (s_ > tg[:, None]).sum(1),
               (s_ == tg[:, None]).sum(1))
        if lse:
            out += (torch.logsumexp(CAP * torch.tanh(s_ / CAP), -1),)
        return out

    n_e, rows = N_EVAL, int(torch.unique(te).numel())
    io_e = 2 * (n_e * D + C * D) + 4 * 2 * n_e + 8 * n_e
    ekw = dict(c_lo=1, c_hi=C, logit_softcap=CAP, with_lse=True,
               tgt_scores=tg)
    runs = {
        "mips_topk_k128": (lambda: mips_topk(q, xs, 128),
                           lambda: torch.topk(q @ xs.T, 128),
                           (2 * (N_B * D + N_POS * D) + 8 * N_B * 128,
                            2 * N_B * N_POS * D, 0),
                           lambda: ref.mips_topk_ref(q, xs, 128)),
        "mips_topk_k1024": (lambda: mips_topk(q, yb, 1024),
                            lambda: torch.topk(q @ yb.T, 1024),
                            (2 * (N_B * D + C * D) + 8 * N_B * 1024,
                             2 * N_B * C * D, 0),
                            lambda: ref.mips_topk_ref(q, yb, 1024)),
        "eval_fused": (lambda: eval_fused.eval_fused(xe, yb, te, 1, **ekw),
                       lambda: lib_eval(True),
                       (io_e + 16 * n_e, 2 * n_e * C * D, n_e * C),
                       lambda: ref.eval_fused_ref(xe, yb, te, 1, **ekw)),
        "eval_topk": (lambda: eval_topk.eval_topk(xe, yb, tg, 1, c_lo=1,
                                                  c_hi=C),
                      lambda: lib_eval(False), (io_e, 2 * n_e * C * D, 0),
                      lambda: ref._two_pass_topk_ref(xe, yb, tg, 1, c_lo=1,
                                                     c_hi=C)),
        "eval_tgt_gather": (lambda: eval_fused.eval_tgt_gather(xe, yb, te),
                            lambda: (xe * yb[te.long()]).float().sum(-1),
                            (2 * (n_e * D + rows * D) + 8 * n_e,
                             2 * n_e * D, 0),
                            lambda: ref.eval_tgt_gather_ref(xe, yb, te)),
        "eval_tgt_scores": (lambda: eval_topk.eval_tgt_scores(xe, yb, te),
                            lambda: (xe * yb[te.long()]).float().sum(-1),
                            (2 * (n_e * D + rows * D) + 8 * n_e,
                             2 * n_e * D, 0),
                            lambda: ref._two_pass_tgt_scores_ref(xe, yb, te)),
    }
    if with_library:
        return runs
    return {k: v[0] for k, v in runs.items()
            if k in ("mips_topk_k128", "mips_topk_k1024", "eval_fused")}


PLAIN = "--plain" in sys.argv  # slab: also time each plain version


def slab(tree, label, *names):
    torch, cs, dev, g, args, pos, gg = _setup(tree)
    runs = _slab_inputs(torch, dev, g, args[1], with_library=True)
    runs = {k: v for k, v in runs.items() if not names or k in names}
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    out = {}
    with torch.no_grad():
        for name, (fn, lib, bound, plain) in runs.items():
            reps = 3 if name.startswith("eval_") and "tgt" not in name else 5
            ms = cs.time_ms(fn, reps, flush)
            b = cs.bf16_bound(*bound)
            ks = _kernel_split(torch, lambda: (flush.zero_(), fn()))[1:]
            parts = {"slab": 0.0, "readers": 0.0, "target": 0.0,
                     "other": 0.0}
            for k, t in ks:
                kind = ("slab" if "gemm" in k else
                        "target" if "tgt" in k else
                        "readers" if any(w in k for w in (
                            "sweep", "pass", "tau", "select", "merge",
                            "sample", "finish")) else "other")
                parts[kind] += t
            out[name] = {"ms": ms, "library_ms": cs.time_ms(lib, 2, flush),
                         "plain_ms": (cs.time_ms(plain, 1, flush)
                                      if PLAIN else None),
                         "bound_ms": b[0], "bound_by": b[2],
                         "parts_ms": parts, "kernels": ks}
    print(label, json.dumps({"slab": out, "card": cs.smi()}), flush=True)


_TC_HEAD = ("template <bool A_KM, bool B_KN, bool GATHER, bool ACC, "
            "typename TA,\n          typename TB>\n__global__")
_TC_PATCH = [  # deep_tc.cuh: prologue, wait, issue, copies, drain, add, epilogue
    (_TC_HEAD, "__device__ unsigned long long kProf[8];\n" + _TC_HEAD),
    ("  extern __shared__ __align__(128) float smem[];",
     "  const long long P0 = clock64();\n"
     "  extern __shared__ __align__(128) float smem[];"),
    ("  for (int t = 0; t < chunks; ++t) {\n"
     "    tf32x3::cp_async_wait<kStages - 2>();  // chunk t + 1 has landed\n"
     "    __syncthreads();\n",
     "  long long P1 = clock64(), PA = 0, PB = 0, PC = 0, PD = 0, PE = 0;\n"
     "  for (int t = 0; t < chunks; ++t) {\n"
     "    asm volatile(\"\" ::: \"memory\");\n"
     "    const long long Pa = clock64();\n"
     "    tf32x3::cp_async_wait<kStages - 2>();  // chunk t + 1 has landed\n"
     "    __syncthreads();\n"
     "    const long long Pb = clock64();\n"),
    ("    if (more) publish();\n",
     "    if (more) publish();\n"
     "    asm volatile(\"\" ::: \"memory\");\n"
     "    const long long Pc = clock64();\n"),
    ("    wgmma_wait<0>();\n    fence_regs(p0);\n    fence_regs(p1);\n",
     "    asm volatile(\"\" ::: \"memory\");\n"
     "    const long long Pd = clock64();\n"
     "    wgmma_wait<0>();\n    fence_regs(p0);\n    fence_regs(p1);\n"
     "    const long long Pe = clock64();\n"),
    ("      for (int i = 0; i < 64; ++i) acc[i] += p1[i];\n    }\n  }\n",
     "      for (int i = 0; i < 64; ++i) acc[i] += p1[i];\n    }\n"
     "    fence_regs(acc);\n"
     "    const long long Pf = clock64();\n"
     "    PA += Pb - Pa; PB += Pc - Pb; PC += Pd - Pc; PD += Pe - Pd;\n"
     "    PE += Pf - Pe;\n  }\n"
     "  const long long P2 = clock64();\n"),
    ("        if (n + 1 < g.n) o[1] = ACC ? o[1] + v1 : v1;\n      }\n"
     "    }\n  }\n}\n",
     "        if (n + 1 < g.n) o[1] = ACC ? o[1] + v1 : v1;\n      }\n"
     "    }\n  }\n"
     "  const long long P3 = clock64();\n"
     "  if ((threadIdx.x & 31) == 0) {\n"
     "    atomicAdd(&kProf[0], (unsigned long long)(P1 - P0));\n"
     "    atomicAdd(&kProf[1], (unsigned long long)PA);\n"
     "    atomicAdd(&kProf[2], (unsigned long long)PB);\n"
     "    atomicAdd(&kProf[3], (unsigned long long)PC);\n"
     "    atomicAdd(&kProf[4], (unsigned long long)PD);\n"
     "    atomicAdd(&kProf[5], (unsigned long long)PE);\n"
     "    atomicAdd(&kProf[6], (unsigned long long)(P3 - P2));\n"
     "    atomicAdd(&kProf[7], (unsigned long long)chunks);\n  }\n}\n"),
]
_TC_PHASES = ("prologue", "wait", "issue", "copies", "drain", "add",
              "epilogue")

_BF_PATCH = [  # gemm_bf16_kernel: consumer wait, issue, drain, epilogue;
    # producer empty, copy
    ("template <bool A_KM, bool B_KN, bool GATHER, bool ACC>\n"
     "__global__ void __launch_bounds__(kBThreads, 1)",
     "__device__ unsigned long long kProf[8];\n"
     "template <bool A_KM, bool B_KN, bool GATHER, bool ACC>\n"
     "__global__ void __launch_bounds__(kBThreads, 1)"),
    ("        mbar_wait(empty + s, (uint32_t)((it / kBStages) & 1) ^ 1u);\n",
     "        const long long Qa = clock64();\n"
     "        mbar_wait(empty + s, (uint32_t)((it / kBStages) & 1) ^ 1u);\n"
     "        const long long Qb = clock64();\n"
     "        QE += Qb - Qa;\n"),
    ("          mbar_arrive_cp_async(full + s);\n        }\n",
     "          mbar_arrive_cp_async(full + s);\n        }\n"
     "        asm volatile(\"\" ::: \"memory\");\n"
     "        QC += clock64() - Qb;\n"),
    ("    long it = 0;\n    for (long t = blockIdx.x; t < g.tiles;",
     "    long long QE = 0, QC = 0;\n"
     "    long it = 0;\n    for (long t = blockIdx.x; t < g.tiles;"),
    ("    return;\n  }\n\n  // the consumer warpgroups",
     "    if ((threadIdx.x & 31) == 0) {\n"
     "      atomicAdd(&kProf[4], (unsigned long long)QE);\n"
     "      atomicAdd(&kProf[5], (unsigned long long)QC);\n    }\n"
     "    return;\n  }\n\n  // the consumer warpgroups"),
    ("  long it = 0;\n  for (long t = blockIdx.x; t < g.tiles; t += gridDim.x) {\n",
     "  long long PW = 0, PI = 0, PD = 0, PE = 0, NS = 0;\n"
     "  long it = 0;\n  for (long t = blockIdx.x; t < g.tiles; t += gridDim.x) {\n"),
    ("      mbar_wait(full + s, (uint32_t)((it / kBStages) & 1));\n",
     "      asm volatile(\"\" ::: \"memory\");\n"
     "      const long long Pa = clock64();\n"
     "      mbar_wait(full + s, (uint32_t)((it / kBStages) & 1));\n"
     "      const long long Pb = clock64();\n"),
    ("      wgmma_commit();\n      wgmma_wait<1>();",
     "      wgmma_commit();\n"
     "      const long long Pc = clock64();\n"
     "      wgmma_wait<1>();"),
    ("      if (prev >= 0) mbar_arrive(empty + prev);\n      prev = s;\n",
     "      if (prev >= 0) mbar_arrive(empty + prev);\n      prev = s;\n"
     "      asm volatile(\"\" ::: \"memory\");\n"
     "      const long long Pd = clock64();\n"
     "      PW += Pb - Pa; PI += Pc - Pb; PD += Pd - Pc; ++NS;\n"),
    ("    wgmma_wait<0>();\n    fence_regs(acc);\n    mbar_arrive(empty + prev);\n",
     "    const long long Pe = clock64();\n"
     "    wgmma_wait<0>();\n    fence_regs(acc);\n    mbar_arrive(empty + prev);\n"),
    ("            if (n + 1 < g.n) o[1] = ACC ? o[1] + v1 : v1;\n"
     "          }\n        }\n      }\n    }\n  }\n}\n",
     "            if (n + 1 < g.n) o[1] = ACC ? o[1] + v1 : v1;\n"
     "          }\n        }\n      }\n    }\n"
     "    asm volatile(\"\" ::: \"memory\");\n"
     "    PE += clock64() - Pe;\n  }\n"
     "  if ((threadIdx.x & 31) == 0) {\n"
     "    atomicAdd(&kProf[0], (unsigned long long)PW);\n"
     "    atomicAdd(&kProf[1], (unsigned long long)PI);\n"
     "    atomicAdd(&kProf[2], (unsigned long long)PD);\n"
     "    atomicAdd(&kProf[3], (unsigned long long)PE);\n"
     "    atomicAdd(&kProf[6], (unsigned long long)NS);\n  }\n}\n"),
]
_BF_PHASES = ("wait", "issue", "drain", "epilogue")

_GETTER = """
extern "C" int deep_prof_read(unsigned long long* out) {
  static const unsigned long long zero[8] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, %s::kProf, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(%s::kProf, zero, sizeof(zero));
  return (int)e;
}
"""


def _shares(v, phases, bf16):
    """The counters of one profiled call as each phase's share of the
    warps' cycles (see the module docstring)."""
    if bf16:
        cyc = v[:4]
        total = sum(cyc)
        prod = v[4] + v[5]
        return {
            "consumer_share": {p: round(c / max(total, 1), 4)
                               for p, c in zip(phases, cyc)},
            "producer_share": {"empty": round(v[4] / max(prod, 1), 4),
                               "copy": round(v[5] / max(prod, 1), 4)},
            "cycles_per_warp_stage": round(sum(cyc[:3]) / max(v[6], 1), 1)}
    cyc = v[:len(phases)]
    total = sum(cyc)
    return {"share": {p: round(c / max(total, 1), 4)
                      for p, c in zip(phases, cyc)},
            "cycles_per_warp_chunk": round(
                sum(cyc[1:-1]) / max(v[7], 1), 1)}


def profile(tree, label, kind="f32"):
    """The clock profile (see the module docstring) of TREE's product, or
    of its bf16 product with ``kind`` "bf16", or of its deep eval sweep
    with ``kind`` "sweep"."""
    import ctypes

    if kind == "sweep":
        return _profile_sweep(tree, label)

    work = Path(tempfile.mkdtemp(prefix="deep_prof_"))
    shutil.copytree(Path(tree) / "src", work / "src")
    shutil.copy(Path(tree) / "chip_smoke.py", work / "chip_smoke.py")
    csrc = work / "src" / "repro_torch" / "kernels" / "csrc"
    sce = (csrc / "sce_gather.cu").read_text()
    header, patch, ns, phases = ("deep_tc.cuh", _TC_PATCH, "deep_tc",
                                 _TC_PHASES)
    text = (csrc / header).read_text()
    if kind == "bf16":
        if "gemm_bf16_kernel" not in text:
            print(label, json.dumps({"profile": "no bf16 product"}),
                  flush=True)
            return
        patch, phases = _BF_PATCH, _BF_PHASES
    if kind == "slab":  # the product the bf16 score slab calls
        body = text[text.index("cudaError_t score_slab("):]
        body = body[:body.index("\n}\n")]
        if "gemm_bf16" in body:
            patch, phases = _BF_PATCH, _BF_PHASES
    for old, new in patch:
        if text.count(old) != 1:
            raise SystemExit(f"profile: anchor not found once in {header}: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    (csrc / header).write_text(text)
    (csrc / "sce_gather.cu").write_text(sce + _GETTER % (ns, ns))
    for lib_name in ("mips_topk", "eval_fused"):
        src = csrc / f"{lib_name}.cu"
        src.write_text(src.read_text() + _GETTER % (ns, ns))
    os.chdir(work)
    torch, cs, dev, g, args, pos, gg = _setup(str(work))
    from repro_torch.kernels import _build, sce_prefetch

    lib = _build.load("sce_gather")
    lib.deep_prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 8)()
    if kind == "slab":
        runs = _slab_inputs(torch, dev, g, args[1])
        out = {}
        for name, fn in runs.items():
            lib = _build.load("eval_fused" if name == "eval_fused"
                              else "mips_topk")
            lib.deep_prof_read.argtypes = [ctypes.c_void_p]
            fn()
            torch.cuda.synchronize()
            lib.deep_prof_read(buf)  # reset after the warm call
            fn()
            torch.cuda.synchronize()
            if lib.deep_prof_read(buf) != 0:
                raise SystemExit("profile: deep_prof_read failed")
            out[name] = _shares([int(v) for v in buf], phases,
                                patch is _BF_PATCH)
        print(label, json.dumps({"product": ns, "kind": kind,
                                 "phases_of": "gemm_bf16" if patch is
                                 _BF_PATCH else "gemm", "profile": out,
                                 "card": cs.smi()}), flush=True)
        return
    kw = dict(logit_softcap=CAP)
    if kind == "bf16":
        args = tuple(t.to(torch.bfloat16) if t.is_floating_point() else t
                     for t in args)
    plse = sce_prefetch.sce_gather_plse_fwd(*args, **kw)
    bargs = args + (plse, gg)

    def read(fn):
        fn()
        torch.cuda.synchronize()
        lib.deep_prof_read(buf)  # reset after the warm call
        fn()
        torch.cuda.synchronize()
        if lib.deep_prof_read(buf) != 0:
            raise SystemExit("profile: deep_prof_read failed")
        return [int(v) for v in buf]

    logits = read(lambda: sce_prefetch.sce_gather_plse_fwd(*args, **kw))
    dx = read(lambda: sce_prefetch.sce_gather_plse_dx(*bargs, **kw))
    dy = read(lambda: sce_prefetch.sce_gather_plse_dy(*bargs, **kw))
    out = {}
    for name, v in (("logits", logits),
                    ("dx", [a - b for a, b in zip(dx, logits)]),
                    ("dy", [a - b for a, b in zip(dy, logits)])):
        out[name] = _shares(v, phases, kind == "bf16")
    print(label, json.dumps({"product": ns, "kind": kind, "profile": out,
                             "card": cs.smi()}), flush=True)


# ---------------------------------------------------------------------------
# The deep eval sweep that reads the score slab (topk_tile.cuh FROM_S)
# ---------------------------------------------------------------------------
SWEEP_ROWS = 1024  # one eval slab: deep.slab_rows(8,192, 256,000)
_SWEEP_PHASES = ("sync", "tau", "merge", "loads", "hook", "filter", "tail",
                 "prologue", None, "reads")
_HOOK_PHASES = ("counts", "tanh", "max", "exps")
_PF_HEAD = (
    "__device__ unsigned long long kProfS[16];\n"
    "#define PF_MARK(j) do { asm volatile(\"\" ::: \"memory\"); "
    "const long long t_ = clock64(); PF[j] += t_ - pc_; pc_ = t_; "
    "} while (0)\n")
_PF_FORCE = (  # the tile's scores have landed: a use of every one
    "    {\n      unsigned zz_ = 0;\n"
    "#pragma unroll\n      for (int mt = 0; mt < MT; ++mt)\n"
    "#pragma unroll\n        for (int nt = 0; nt < NT; ++nt)\n"
    "#pragma unroll\n          for (int e = 0; e < 4; ++e)\n"
    "            zz_ |= __float_as_uint(acc[mt][nt][e]);\n"
    "      asm volatile(\"\" :: \"r\"(zz_));\n    }\n    PF_MARK(3);\n")
_PF_TAIL = (
    "  PF_MARK(6);\n"
    "  if (!SAMPLE && (tid & 31) == 0) {\n"
    "#pragma unroll\n    for (int j = 0; j < 10; ++j)\n"
    "      atomicAdd(&kProfS[j], (unsigned long long)PF[j]);\n  }\n")
# The parent's sweep (scalar FROM_S loads into the fragments), by anchor.
_SWEEP_PATCH_SCALAR = [
    ("namespace topk_tile {\n\n", "namespace topk_tile {\n\n" + _PF_HEAD),
    ("  constexpr int THREADS = C::kThreads;\n  const int d = a.d;\n",
     "  constexpr int THREADS = C::kThreads;\n  const int d = a.d;\n"
     "  long long PF[10] = {};\n  long long pc_ = clock64();\n"),
    ("  for (int i = 0; i < n_tiles; ++i) {\n    cp_async_wait<0>();\n",
     "  PF_MARK(7);\n"
     "  for (int i = 0; i < n_tiles; ++i) {\n    cp_async_wait<0>();\n"),
    ("    const int f_next = i + 1 < n_tiles ? issue(i + 1) : 0;\n"
     "    cp_async_commit();\n",
     "    const int f_next = i + 1 < n_tiles ? issue(i + 1) : 0;\n"
     "    cp_async_commit();\n    PF_MARK(0);\n"),
    ("(int)0x80808080;\n        }\n    }\n",
     "(int)0x80808080;\n        }\n    }\n    PF_MARK(1);\n"),
    ("    if (tid == 0) mreq[(i + 1) % 3] = 0;  // tile i − 2's, read at i − 1\n",
     "    if (tid == 0) mreq[(i + 1) % 3] = 0;  // tile i − 2's, read at i − 1\n"
     "    PF_MARK(2);\n"),
    ("                cr < a.c && qr < a.n_q ? a.s[cr * a.n_q + qr] : 0.f;\n"
     "          }\n    }\n",
     "                cr < a.c && qr < a.n_q ? a.s[cr * a.n_q + qr] : 0.f;\n"
     "          }\n    }\n" + _PF_FORCE),
    ("    on_tile(acc, fl, c0);\n", "    on_tile(acc, fl, c0);\n    PF_MARK(4);\n"),
    ("    f_mine = f_next;\n  }\n",
     "    f_mine = f_next;\n    PF_MARK(5);\n    ++PF[8];\n  }\n"),
    ("        a.part_ids[o] = li[e];\n      }\n    }\n  }\n  return ring;\n",
     "        a.part_ids[o] = li[e];\n      }\n    }\n  }\n" + _PF_TAIL +
     "  return ring;\n"),
]
# eval_fused.cu's hook, as the parent runs it, split into its phases (the
# same arithmetic and order; each phase's results used before its clock).
_HOOK_BODY = r"""[&](const float (&acc)[MT][NT][4], const int* flags, long c0) {
        long long h0 = clock64();
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int cc = 16 * (wm * MT + mt) + gq + 8 * h;
                const float x = acc[mt][nt][2 * h + u];
                const bool ok = flags[cc] != 0;
                const bool self =
                    SELF && a.id_offset + (int)(c0 + cc) == id_r[nt][u];
                const float sv = ok ? x : kNegInf;
                gt[nt][u] += sv > t_r[nt][u] && !self;
                eq[nt][u] += sv == t_r[nt][u] || (self && ok);
              }
        {
          unsigned zz = 0;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int u = 0; u < 2; ++u) zz |= gt[nt][u] | eq[nt][u];
          asm volatile("" :: "r"(zz) : "memory");
        }
        long long h1 = clock64();
        HC_ += h1 - h0;
        if (LSE) {
          float lv[NT][2][MT][2];
          unsigned zz = 0;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const float x = acc[mt][nt][2 * h + u];
                  const float v = cap > 0.f ? cap * tanhf(x / cap) : x;
                  lv[nt][u][mt][h] =
                      flags[16 * (wm * MT + mt) + gq + 8 * h] ? v : kNegInf;
                  zz |= __float_as_uint(lv[nt][u][mt][h]);
                }
          asm volatile("" :: "r"(zz) : "memory");
          long long h2 = clock64();
          HT_ += h2 - h1;
          float mx[NT][2];
          zz = 0;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float tile_max = kNegInf;
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  tile_max = fmaxf(tile_max, lv[nt][u][mt][h]);
              mx[nt][u] = fmaxf(m[nt][u], tile_max);
              zz |= __float_as_uint(mx[nt][u]);
            }
          asm volatile("" :: "r"(zz) : "memory");
          long long h3 = clock64();
          HM_ += h3 - h2;
          zz = 0;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float mn = mx[nt][u];
              float add = 0.f;
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  if (flags[16 * (wm * MT + mt) + gq + 8 * h])
                    add += expf(lv[nt][u][mt][h] - mn);
              s[nt][u] = s[nt][u] * expf(m[nt][u] - mn) + add;
              m[nt][u] = mn;
              zz |= __float_as_uint(s[nt][u]);
            }
          asm volatile("" :: "r"(zz) : "memory");
          HE_ += clock64() - h3;
        }
      });
"""
_HOOK_STATE = ("  float* red = sweep<",
               "  long long HC_ = 0, HT_ = 0, HM_ = 0, HE_ = 0;\n"
               "  float* red = sweep<")
_HOOK_TAIL = ("      part_ms[2 * o + 1] = ss;\n    }\n  }\n}\n",
              "      part_ms[2 * o + 1] = ss;\n    }\n  }\n"
              "  if ((threadIdx.x & 31) == 0) {\n"
              "    atomicAdd(&kProfS[10], (unsigned long long)HC_);\n"
              "    atomicAdd(&kProfS[11], (unsigned long long)HT_);\n"
              "    atomicAdd(&kProfS[12], (unsigned long long)HM_);\n"
              "    atomicAdd(&kProfS[13], (unsigned long long)HE_);\n"
              "  }\n}\n")
_SWEEP_GETTER = """
extern "C" int sweep_prof_read(unsigned long long* out) {
  static const unsigned long long zero[16] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, topk_tile::kProfS, sizeof(zero));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(topk_tile::kProfS, zero, sizeof(zero));
  return (int)e;
}
"""


def _patch(text, patch, name):
    for old, new in patch:
        if text.count(old) != 1:
            raise SystemExit(f"profile: anchor not found once in {name}: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


# The ring's sweep (TMA boxes, the stage's mbarrier, shared-memory
# reads): "loads" is the mbarrier wait, "reads" the stage's LDS.64.
_SWEEP_PATCH_RING = [
    _SWEEP_PATCH_SCALAR[0], _SWEEP_PATCH_SCALAR[1], _SWEEP_PATCH_SCALAR[2],
    ("      slab_copy(i + kSlabStages - 1);\n",
     "      slab_copy(i + kSlabStages - 1);\n    PF_MARK(0);\n"),
    _SWEEP_PATCH_SCALAR[4], _SWEEP_PATCH_SCALAR[5],
    ("                         (uint32_t)((i / kSlabStages) & 1));\n",
     "                         (uint32_t)((i / kSlabStages) & 1));\n"
     "      PF_MARK(3);\n"),
    ("            acc[mt][nt][2 * h + 1] = v.y;\n          }\n    }\n",
     "            acc[mt][nt][2 * h + 1] = v.y;\n          }\n    }\n" +
     _PF_FORCE.replace("PF_MARK(3)", "PF_MARK(9)")),
    _SWEEP_PATCH_SCALAR[7], _SWEEP_PATCH_SCALAR[8], _SWEEP_PATCH_SCALAR[9],
]
_HOOK_BODY_RING = (  # the slab's LSE: base-2 units on the SFU
    _HOOK_BODY.replace("cap > 0.f ? cap * tanhf(x / cap) : x",
                       "logit2(x, cap, kt, kv)")
    .replace("expf(", "exp_("))


def _sweep_patches(topk):
    """The clock patch of a tree's deep sweep, picked by what its header
    holds: the parent's scalar loads, or the ring of TMA boxes."""
    if "cp.async.bulk.tensor" in topk:
        return _SWEEP_PATCH_RING, _HOOK_BODY_RING
    return _SWEEP_PATCH_SCALAR, _HOOK_BODY


def _sweep_calls(torch, dev, g, y, rows):
    """eval_fused (k 1, the LSE, cap 30) and eval_topk (k 1) on ``rows``
    rows against the vocabulary, on bf16 and on f32 operands: name →
    (call, its slab's rows, the inputs)."""
    from repro_torch.kernels import eval_fused, eval_topk

    xe = torch.randn(rows, D, generator=g, device=dev)
    te = torch.randint(1, C, (rows,), generator=g, device=dev,
                       dtype=torch.int32)
    calls = {}
    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        x_, y_ = xe.to(dt), y.to(dt)
        tg = eval_fused.eval_tgt_gather(x_, y_, te)
        calls[f"eval_fused_{tag}"] = (
            lambda x_=x_, y_=y_, tg=tg: eval_fused.eval_fused(
                x_, y_, te, 1, tgt_scores=tg, c_lo=1, c_hi=C,
                logit_softcap=CAP, with_lse=True), (x_, y_, te, tg))
        calls[f"eval_topk_{tag}"] = (
            lambda x_=x_, y_=y_, tg=tg: eval_topk.eval_topk(
                x_, y_, tg, 1, c_lo=1, c_hi=C), (x_, y_, te, tg))
    return calls


def _profile_sweep(tree, label):
    """The deep eval sweep's clock profile (module docstring: ``profile
    ... sweep``) on one slab of 1,024 rows."""
    import ctypes

    work = Path(tempfile.mkdtemp(prefix="sweep_prof_"))
    shutil.copytree(Path(tree) / "src", work / "src")
    shutil.copy(Path(tree) / "chip_smoke.py", work / "chip_smoke.py")
    csrc = work / "src" / "repro_torch" / "kernels" / "csrc"
    topk = (csrc / "topk_tile.cuh").read_text()
    patch, hook = _sweep_patches(topk)
    (csrc / "topk_tile.cuh").write_text(_patch(topk, patch, "topk_tile.cuh"))
    ev = (csrc / "eval_fused.cu").read_text()
    start = ev.index("[&](const float (&acc)[MT][NT][4], const int* flags,")
    end = ev.index("      });\n", start) + len("      });\n")
    ev = ev[:start] + hook + ev[end:]
    ev = _patch(ev, [_HOOK_STATE, _HOOK_TAIL], "eval_fused.cu")
    (csrc / "eval_fused.cu").write_text(ev + _SWEEP_GETTER)
    os.chdir(work)
    torch, cs, dev, g, args, pos, gg = _setup(str(work))
    from repro_torch.kernels import _build

    lib = _build.load("eval_fused")
    lib.sweep_prof_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 16)()
    out = {}
    with torch.no_grad():
        for name, (fn, _) in _sweep_calls(torch, dev, g, args[1],
                                          SWEEP_ROWS).items():
            fn()
            torch.cuda.synchronize()
            lib.sweep_prof_read(buf)  # reset after the warm call
            fn()
            torch.cuda.synchronize()
            if lib.sweep_prof_read(buf) != 0:
                raise SystemExit("profile: sweep_prof_read failed")
            v = [int(x) for x in buf]
            ph = {p: c for p, c in zip(_SWEEP_PHASES, v[:10]) if p}
            total = sum(ph.values())
            loop = total - ph["tail"] - ph["prologue"]
            hook = sum(v[10:14])
            out[name] = {
                "share": {p: round(c / max(total, 1), 4)
                          for p, c in ph.items()},
                "hook_share": {p: round(c / max(hook, 1), 4)
                               for p, c in zip(_HOOK_PHASES, v[10:14])},
                "cycles_per_warp_tile": round(loop / max(v[8], 1), 1),
                "warp_tiles": v[8]}
    print(label, json.dumps({"sweep_profile": out, "rows": SWEEP_ROWS,
                             "card": cs.smi()}), flush=True)


def _parts(ks, n_slabs):
    """A call's kernels (name, ms) summed by kind, per slab."""
    parts = dict.fromkeys(("slab", "prepass", "sweep", "merge", "target",
                           "other"), 0.0)
    for k, t in ks:
        kind = ("slab" if "gemm" in k else
                "prepass" if "sample" in k or "tau_select" in k else
                "sweep" if "sweep_kernel" in k else
                "merge" if "merge" in k else
                "target" if "tgt" in k else "other")
        parts[kind] += t / n_slabs
    parts["sweep_alone"] = parts["prepass"] + parts["sweep"] + parts["merge"]
    return {k: round(v, 4) for k, v in parts.items()}


def sweep_plans(tree, label):
    """The deep sweep of TREE under plan variants (module docstring:
    ``plans``)."""
    torch, cs, dev, g, args, pos, gg = _setup(tree)
    from repro_torch.kernels import mips_topk as mk

    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    calls = _sweep_calls(torch, dev, g, args[1], SWEEP_ROWS)
    tree_plan = mk.slab_sweep_plan
    variants = {
        "tree": tree_plan,
        "split8": lambda *_: mk.SweepPlan(4, 8, 8, 64),
        "split12": lambda *_: mk.SweepPlan(4, 12, 12, 96),
        "split16_nopre": lambda *_: mk.SweepPlan(4, 16, 0, 0),
        "split24": lambda *_: mk.SweepPlan(4, 24, 16, 128),
        "split33": lambda *_: mk.SweepPlan(4, 33, 16, 128),
        "nqt1_split4": lambda *_: mk.SweepPlan(1, 4, 4, 32),
    }
    out = {}
    with torch.no_grad():
        for vn, plan in variants.items():
            mk.slab_sweep_plan = plan
            mk.sweep_plan.cache_clear()
            for name in ("eval_fused_bf16", "eval_topk_bf16"):
                fn = calls[name][0]
                ks = _kernel_split(torch, lambda: (flush.zero_(), fn()))[1:]
                out[f"{vn}/{name}"] = _parts(ks, 1)
    mk.slab_sweep_plan = tree_plan
    mk.sweep_plan.cache_clear()
    print(label, json.dumps({"plans": out, "card": cs.smi()}), flush=True)


def sweep_turns(tree, label):
    """The deep eval sweep of TREE (module docstring: ``sweep``)."""
    torch, cs, dev, g, args, pos, gg = _setup(tree)
    y = args[1]
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    n_slabs = N_EVAL // SWEEP_ROWS
    out = {}
    with torch.no_grad():
        calls = _sweep_calls(torch, dev, g, y, N_EVAL)
        for name, (fn, (x_, y_, te, tg)) in calls.items():
            reps = 1 if name.endswith("f32") else 3
            ks = _kernel_split(torch, lambda: (flush.zero_(), fn()))[1:]
            out[name] = {"ms": cs.time_ms(fn, reps, flush),
                         "per_slab_ms": _parts(ks, n_slabs)}
        del calls
        # PyTorch on one given slab (the kernel's own, 1,024 rows): the
        # top-1 (torch.max: the first maximal index), the counts against
        # the target scores under the window [1, C), and the capped LSE
        from repro_torch.kernels import eval_fused

        slab_bytes = 4 * SWEEP_ROWS * C
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            xs, ys = (torch.randn(SWEEP_ROWS, D, generator=g, device=dev)
                      .to(dt), y.to(dt))
            te = torch.randint(1, C, (SWEEP_ROWS,), generator=g, device=dev,
                               dtype=torch.int32)
            tg = eval_fused.eval_tgt_gather(xs, ys, te)
            s = eval_fused.score_slab(xs, ys)[1:]

            def lib_topk(s=s, tg=tg):
                return s.max(0), (s > tg).sum(0), (s == tg).sum(0)

            def lib_fused(s=s, tg=tg):
                return lib_topk(s, tg) + (torch.logsumexp(
                    CAP * torch.tanh(s / CAP), 0),)

            out[f"library_slab_{tag}"] = {
                "eval_fused_ms": cs.time_ms(lib_fused, 3, flush),
                "eval_topk_ms": cs.time_ms(lib_topk, 3, flush),
                "bound_ms": slab_bytes / cs.PEAK_BYTES_S * 1e3}
            del s
    print(label, json.dumps({"sweep": out, "card": cs.smi()}), flush=True)


if __name__ == "__main__":
    mode, tree, label = sys.argv[1:4]
    {"digests": digests, "times": times, "profile": profile,
     "slab": slab, "sweep": sweep_turns, "plans": sweep_plans}[mode](
        tree, label, *[a for a in sys.argv[4:] if a != "--plain"])
