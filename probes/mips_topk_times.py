#!/usr/bin/env python3
"""Device times of ``mips_topk`` on the card (CUDA events, each call after
a 1 GiB L2 flush). Needs an NVIDIA GPU.

    python3 probes/mips_topk_times.py serve TREE LABEL
    python3 probes/mips_topk_times.py sweep

``serve`` imports ``repro_torch`` from ``TREE/src`` (a checkout of any
commit, for example the parent unpacked with ``git archive``), builds
its kernels and prints ``LABEL {"8": ms, "32": ms, "512": ms}``: the mean
of 200 calls at serving's shapes (n_q 8 / 32 / 512, C = 173,520 catalog
rows, d = 64, k = 10, window [1, 173,511)). Run two trees in turns
(parent, change, change, parent) on one card to compare them.

``sweep`` runs this tree's wrapper at SCE training's two selections — 320
bucket centres against 25,600 positions (k = 320, ≈ 25 % masked) and
against the 173,520 catalog rows (k = 256) — and prints the time of the
wrapper's own plan, then of 16-row blocks at each split count of
``SPLITS``, in two interleaved rounds of 20 calls each (the spread
between the rounds is the noise), and the ``torch.profiler`` split
between the partial and the merge kernel at the plan.
"""
import json
import sys

SPLITS = {"positions_k320": (6, 8, 10, 12, 13, 14, 16, 24),
          "catalog_k256": (8, 12, 13, 14, 16, 24, 26, 27, 32, 64)}


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


def serve(tree, label):
    sys.path.insert(0, tree + "/src")
    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.mips_topk import mips_topk

    dev = resolve_device("cuda")
    _build.build_all()
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn(173_520, 64, generator=g, device=dev) * 0.02
    ar = torch.arange(173_520, device=dev)
    window = (ar >= 1) & (ar < 173_511)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    out = {}
    for n_q in (8, 32, 512):
        q = torch.randn(n_q, 64, generator=g, device=dev)
        out[n_q] = time_ms(lambda: mips_topk(q, y, 10, valid=window), 200,
                           flush)
    print(label, json.dumps(out))


def sweep():
    sys.path.insert(0, "src")
    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import mips_topk as mk

    dev = resolve_device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    b = torch.randn(320, 64, generator=g, device=dev)
    x = torch.randn(25_600, 64, generator=g, device=dev)
    y = torch.randn(173_520, 64, generator=g, device=dev) * 0.125
    valid = torch.rand(25_600, generator=g, device=dev) > 0.25
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    own_plan = mk.plan
    for name, (cat, k, vm) in {"positions_k320": (x, 320, valid),
                               "catalog_k256": (y, 256, None)}.items():
        c = cat.shape[0]
        run = lambda: mk.mips_topk(b, cat, k, valid=vm)  # noqa: E731
        print(f"{name} wrapper plan {own_plan(320, c, 64, k, n_sm)} ms "
              f"{time_ms(run, 20, flush):.4f}")
        tiles = -(-c // mk.TILE_C)
        rounds = {s: [] for s in SPLITS[name]}
        try:
            for _ in range(2):
                for n_split in SPLITS[name]:
                    sc = -(-tiles // n_split) * mk.TILE_C
                    mk.plan = (lambda *a, sc=sc, c=c:
                               mk.Plan(1, -(-c // sc), sc))
                    rounds[n_split].append(time_ms(run, 20, flush))
        finally:
            mk.plan = own_plan
        for n_split, ts in rounds.items():
            print(f"  rm=1 n_split={n_split} ms " +
                  " ".join(f"{t:.4f}" for t in ts))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "mips_topk" in ev.key:
                print(f"  profiler {ev.key[:60]}: "
                      f"{ev.device_time_total / 5 / 1e3:.4f} ms per call")


if __name__ == "__main__":
    if sys.argv[1:2] == ["serve"]:
        serve(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["sweep"]:
        sweep()
    else:
        sys.exit(__doc__)
