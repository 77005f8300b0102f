#!/usr/bin/env python3
"""Device times of ``mips_topk`` on the card (CUDA events, each call after
a 1 GiB L2 flush). Needs an NVIDIA GPU.

    python3 probes/mips_topk_times.py serve TREE LABEL
    python3 probes/mips_topk_times.py train TREE LABEL
    python3 probes/mips_topk_times.py sweep

``serve`` imports ``repro_torch`` from ``TREE/src`` (a checkout of any
commit, for example the parent unpacked with ``git archive``), builds
its kernels and prints ``LABEL {"8": ms, "32": ms, "512": ms, ...}``: the
mean of 200 calls at serving's shapes (n_q 8 / 32 / 512, C = 173,520
catalog rows, d = 64, k = 10, window [1, 173,511)), then of 50 calls of
``eval_fused`` (with its ``eval_tgt_gather`` threshold) and of
``eval_topk`` (with ``eval_tgt_scores``) at the evaluation's B = 256 and
k = 10 — the sweeps that share ``mips_topk``'s tile code.

``train`` does the same at SCE training's two selections — 320 bucket
centres against 25,600 positions (k = 320, ≈ 25 % masked) and against
the 173,520 catalog rows (k = 256), the inputs of ``sweep`` — and prints
``LABEL {"positions_k320": {"ms": …, "sha256": …}, …}``: the mean of 50
calls and a SHA-256 of the output ids and values, so two trees' outputs
compare bit for bit. Run two trees in turns (parent, change, change,
parent) on one card to compare them.

``sweep`` runs this tree's wrapper at the training selections and prints
the time of the wrapper's plan, the mean per-row collect count of the
``k > 32`` chain, each of its kernels' ``torch.profiler`` device time
per call (10 calls, each after the flush: threshold, τ, collect, select,
the finishing sweep), and the chain's time at other threshold samples
and split counts, in two interleaved rounds of 20 calls each (the
spread between the rounds is the noise).
"""
import hashlib
import json
import sys

SAMPLES = (1, 2, 4, 8)
SPLITS = (26, 52, 104)


def time_ms(fn, reps, flush):
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def _setup(tree):
    sys.path.insert(0, tree + "/src")
    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    _build.build_all()
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    return torch, dev, flush


def _train_inputs(torch, dev):
    """The training selections' inputs: (name, q, catalog, k, valid)."""
    g = torch.Generator(device=dev).manual_seed(0)
    b = torch.randn(320, 64, generator=g, device=dev)
    x = torch.randn(25_600, 64, generator=g, device=dev)
    y = torch.randn(173_520, 64, generator=g, device=dev) * 0.125
    valid = torch.rand(25_600, generator=g, device=dev) > 0.25
    return (("positions_k320", b, x, 320, valid),
            ("catalog_k256", b, y, 256, None))


def serve(tree, label):
    torch, dev, flush = _setup(tree)
    from repro_torch.kernels import eval_fused as ef
    from repro_torch.kernels import eval_topk as et
    from repro_torch.kernels.mips_topk import mips_topk

    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn(173_520, 64, generator=g, device=dev) * 0.02
    ar = torch.arange(173_520, device=dev)
    window = (ar >= 1) & (ar < 173_511)
    out = {}
    for n_q in (8, 32, 512):
        q = torch.randn(n_q, 64, generator=g, device=dev)
        out[n_q] = time_ms(lambda: mips_topk(q, y, 10, valid=window), 200,
                           flush)
    x = torch.randn(256, 64, generator=g, device=dev)
    t = torch.randint(1, 173_511, (256,), generator=g, device=dev,
                      dtype=torch.int32)

    def fused():
        ts = ef.eval_tgt_gather(x, y, t)
        return ef.eval_fused(x, y, t, 10, tgt_scores=ts, c_lo=1,
                             c_hi=173_511)

    def two_pass():
        ts = et.eval_tgt_scores(x, y, t)
        return et.eval_topk(x, y, ts, 10, c_lo=1, c_hi=173_511)

    out["eval_fused_b256"] = time_ms(fused, 50, flush)
    out["eval_topk_b256"] = time_ms(two_pass, 50, flush)
    print(label, json.dumps(out))


def train(tree, label):
    torch, dev, flush = _setup(tree)
    from repro_torch.kernels.mips_topk import mips_topk

    out = {}
    for name, q, cat, k, vm in _train_inputs(torch, dev):
        vals, ids = mips_topk(q, cat, k, valid=vm)
        torch.cuda.synchronize()
        h = hashlib.sha256(ids.cpu().numpy().tobytes())
        h.update(vals.cpu().numpy().tobytes())
        out[name] = {
            "ms": time_ms(lambda: mips_topk(q, cat, k, valid=vm), 50, flush),
            "sha256": h.hexdigest(),
        }
    print(label, json.dumps(out))


def sweep():
    torch, dev, flush = _setup(".")
    import dataclasses

    from repro_torch.kernels import mips_topk as mk

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    own_plan = mk.select_plan
    for name, q, cat, k, vm in _train_inputs(torch, dev):
        c = cat.shape[0]
        sp = own_plan(320, c, 64, k, n_sm)
        run = lambda: mk.mips_topk(q, cat, k, valid=vm)  # noqa: E731
        print(f"{name} plan {sp} ms {time_ms(run, 20, flush):.4f}")
        counts = mk.mips_topk.last_counts.float()
        print(f"  collected per row mean {counts.mean().item():.1f} max "
              f"{counts.max().item():.0f} (kcap {sp.kcap})")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                flush.zero_()
                run()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "mips_topk" in ev.key:
                print(f"  profiler {ev.key[:70]}: "
                      f"{ev.device_time_total / 10 / 1e3:.4f} ms per call")
        tiles = -(-c // mk.TILE_C)
        variants = [(s, r) for s in SPLITS for r in SAMPLES
                    if s * r <= tiles]
        rounds = {v: [] for v in variants}
        try:
            for _ in range(2):
                for s, r in variants:
                    kcap = min(mk.MAX_SORT, mk._pow2_at_least(2 * r * k))
                    mk.select_plan = (
                        lambda *a, s=s, r=r, kcap=kcap: dataclasses.replace(
                            sp, n_split=s, period=s * r, kcap=kcap))
                    rounds[(s, r)].append(time_ms(run, 20, flush))
        finally:
            mk.select_plan = own_plan
        for (s, r), ts in rounds.items():
            print(f"  n_split={s} sample=1/{r} ms " +
                  " ".join(f"{t:.4f}" for t in ts))


if __name__ == "__main__":
    if sys.argv[1:2] == ["serve"]:
        serve(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["train"]:
        train(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["sweep"]:
        sweep()
    else:
        sys.exit(__doc__)
