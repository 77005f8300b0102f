#!/usr/bin/env python3
"""Time of the trainers' guarded AdamW update at ``sasrec-sce``'s full
width, in any tree. Needs an NVIDIA GPU.

    python3 probes/adamw_guarded_times.py TREE LABEL

imports ``repro_torch`` from ``TREE/src`` (a checkout of any commit, for
example the parent unpacked with ``git archive`` into ``.benchrun/``)
and calls its ``launch/steps.py::_apply_update_guarded`` as the seqrec
trainer does after each step — the arch's optimizer on the
``configs/sasrec_sce.py`` parameters (random from seed 0) with random
gradients, an uncapped finite loss, so every update is kept — 20 calls
a round, 10 rounds. Prints ``LABEL {...}``: per call the median over
rounds of the time between CUDA events recorded before and after the
round (``device_ms``; idle gaps while the host enqueues are inside it)
and of the host's time to enqueue the round (``host_ms``), each round's
values, the leaf and parameter counts, and a SHA-256 of the parameters
and moments after the last call, so two trees' updates compare bit for
bit. Run two trees in turns on one card (parent, change, change,
parent).
"""
import hashlib
import json
import statistics
import sys
import time


def main(tree, label, rounds=10, reps=20):
    sys.path.insert(0, tree + "/src")
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.launch import steps
    from repro_torch.models import sasrec
    from repro_torch.optim.optimizers import (make_optimizer, tree_leaves,
                                              tree_map)

    dev = resolve_device("cuda")
    cfg = make_config()
    params = sasrec.init_params(cfg, seed=0, device=dev)
    init, update = make_optimizer(get_arch("sasrec-sce").optimizer, 1e-3)
    state = init(params)
    g = torch.Generator(device=dev).manual_seed(1)
    grads = tree_map(
        lambda p: torch.randn(p.shape, generator=g, device=dev) * 1e-3,
        params)
    loss = torch.tensor(1.0, device=dev)
    for _ in range(3):  # warm-up
        params, state, _ = steps._apply_update_guarded(update, loss, grads,
                                                       params, state)
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            params, state, m = steps._apply_update_guarded(
                update, loss, grads, params, state)
        end.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        assert not bool(m["skipped"])
        dev_ms.append(start.elapsed_time(end) / reps)
        host_ms.append((t1 - t0) * 1e3 / reps)
    h = hashlib.sha256()
    for t in tree_leaves(params) + tree_leaves(state):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    print(label, json.dumps({
        "device_ms": statistics.median(dev_ms),
        "host_ms": statistics.median(host_ms),
        "rounds_device_ms": dev_ms, "rounds_host_ms": host_ms,
        "leaves": len(tree_leaves(params)),
        "parameters": sum(p.numel() for p in tree_leaves(params)),
        "sha256": h.hexdigest()[:16]}))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
