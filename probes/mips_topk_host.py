#!/usr/bin/env python3
"""Host time of one serving ``mips_topk`` call at bucket 8, piece by
piece, and the serve step's breakdown, in any tree. Needs an NVIDIA GPU.

    python3 probes/mips_topk_host.py TREE LABEL

imports ``repro_torch`` (and ``chip_smoke.py``) from ``TREE`` and prints
``LABEL {...}``: the mean host microseconds per call (``perf_counter``
around 20 calls, 10 rounds, a synchronise between rounds and outside the
clock) of

- ``streaming_topk``: what the serve step calls (the window mask, then
  ``ops.mips_topk``);
- ``ops.mips_topk``: the guard's gate and the wrapper;
- ``wrapper``: ``kernels.mips_topk.mips_topk`` alone (checks, plan,
  allocations, the ctypes launch);
- its pieces as the parent's wrapper runs them: ``gate``
  (``ops._gate`` with the planned shared memory), ``window_mask``,
  ``device_properties`` (``torch.cuda.get_device_properties``),
  ``plan``, ``empty_x4`` (four ``torch.empty`` of the call's outputs and
  split lists), ``device_and_stream`` (``torch.cuda.device`` and
  ``current_stream``);

and the serve step at buckets 8, 32 and 512 by ``chip_smoke``'s
``step_breakdown`` (CUDA events between the step's phases: tokens to
the card, the SASRec forward, the ``mips_topk`` span, results back) on a
``RetrievalServer`` at ``sasrec-sce``'s full width. Run two trees in
turns on one card (parent, change, change, parent).
"""
import importlib.util
import json
import sys
import time
from pathlib import Path


def host_us(fn, torch, calls=20, rounds=10):
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (calls * rounds) * 1e6


def main(tree, label):
    tree = Path(tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    from repro_torch.configs.sasrec_sce import make_config
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.eval.streaming import streaming_topk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import RetrievalServer

    dev = torch.device("cuda", 0)
    c, d, k, n_q = 173_520, 64, 10, 8
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn(c, d, generator=g, device=dev) * 0.02
    q = torch.randn(n_q, d, generator=g, device=dev)
    gids = torch.arange(c, device=dev)
    window = (gids >= 1) & (gids < 173_511)
    plan = getattr(mk, "sweep_plan", None) or mk.plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = plan(n_q, c, d, k, sms).n_split

    def empties():
        return (torch.empty((n_q, k), dtype=torch.float32, device=dev),
                torch.empty((n_q, k), dtype=torch.int32, device=dev),
                torch.empty((n_q, n_split, k), dtype=torch.float32,
                            device=dev),
                torch.empty((n_q, n_split, k), dtype=torch.int32,
                            device=dev))

    def device_and_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    pieces = {
        "streaming_topk": lambda: streaming_topk(q, y, k, c_lo=1,
                                                 c_hi=173_511),
        "ops.mips_topk": lambda: ops.mips_topk(q, y, k, valid=window),
        "wrapper": lambda: mk.mips_topk(q, y, k, valid=window),
        "gate": lambda: ops._gate(
            "mips_topk", q, rows=n_q, cols=c, d=d, k=k,
            smem=ops._sweep_smem(q, y, k, mk.planned_smem)),
        "window_mask": lambda: (gids >= 1) & (gids < 173_511),
        "device_properties": lambda: torch.cuda.get_device_properties(dev),
        "plan": lambda: plan(n_q, c, d, k, sms),
        "empty_x4": empties,
        "device_and_stream": device_and_stream,
    }
    out = {name: host_us(fn, torch) for name, fn in pieces.items()}

    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = make_config()
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=512))
    hist = data.next_batch(Cursor(seed=1))[0]["tokens"]
    server = RetrievalServer("sasrec-sce", cfg=cfg, buckets=(8, 32, 512),
                             top_k=k, queue_size=64, seed=0, device="cuda")
    try:
        out["serve_step"] = smoke.step_breakdown(server, np.asarray(hist))
    finally:
        server.close()
    print(label, json.dumps(out))


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2])
