#!/usr/bin/env python3
"""The CTR models' embedding gather, forward and backward, three ways at
a published config's tables and train_batch. Needs an NVIDIA GPU.

    python3 probes/embedding_backward.py [ARCH]   # default dlrm-rm2

Builds ARCH's tables as ``configs/<arch>.py::make_config()`` publishes
them (random, seed 0) and one clickstream batch of 65,536 rows (the
Zipf ids the trainer sees, ``data/clickstream.py``), then times the
lookup of every field and the gradient of ``Σ emb·w`` (w a fixed random
tensor) into every table, with each gather: advanced indexing
``table[ids]`` (the port's ``take_rows`` on a CUDA device; its backward
sorts the ids and sums each run of one id in a thread), ``F.embedding``
(its backward sorts and splits the runs), and ``index_select`` (its
backward adds with atomics). Prints per gather the median device ms of
forward + backward over 5 runs (CUDA events; the dense gradient's
zero-fill inside), whether two backward runs agree bit for bit, the
largest gradient difference to advanced indexing, and the batch's
largest count of one id in one field.
"""
import json
import statistics
import sys
from pathlib import Path


def main(arch_name="dlrm-rm2", reps=5):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.data import ClickDataConfig, ClickstreamDataset, Cursor
    from repro_torch.launch.steps import RECSYS_INIT

    dev = resolve_device("cuda")
    cfg = get_arch(arch_name).make_config()
    tables = RECSYS_INIT[arch_name](cfg, seed=0, device=dev)["tables"]
    batch, _ = ClickstreamDataset(ClickDataConfig(
        vocab_sizes=cfg.vocab_sizes, batch_size=65_536,
        n_dense=getattr(cfg, "n_dense", 1))).next_batch(Cursor(seed=0))
    ids = torch.from_numpy(batch["sparse_ids"]).to(dev).long()
    w = torch.randn(ids.shape[0], len(tables), cfg.embed_dim,
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    max_dup = max(int(np.bincount(batch["sparse_ids"][:, f, 0]).max())
                  for f in range(len(tables)))
    gathers = {
        "advanced_indexing": lambda t, i: t[i],
        "F.embedding": lambda t, i: F.embedding(i, t),
        "index_select": lambda t, i: torch.index_select(
            t, 0, i.reshape(-1)).reshape(*i.shape, t.shape[1]),
    }

    def run(gather):
        leaves = [t.detach().requires_grad_(True) for t in tables]
        emb = torch.stack([gather(t, ids[:, f]).sum(dim=1)
                           for f, t in enumerate(leaves)], dim=1)
        return torch.autograd.grad((emb * w).sum(), leaves)

    out, base = {}, None
    for name, gather in gathers.items():
        first = run(gather)
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            grads = run(gather)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        same = all(torch.equal(x, y) for x, y in zip(first, grads))
        if base is None:
            base = first
        diff = max((x - y).abs().max().item() for x, y in zip(first, base))
        out[name] = {"median_ms": statistics.median(ms), "ms": ms,
                     "repeats_bitwise": same, "max_abs_diff_to_first": diff}
        del first, grads
    print(json.dumps({"arch": arch_name, "rows": ids.shape[0],
                      "fields": len(tables),
                      "table_rows": sum(cfg.vocab_sizes),
                      "embed_dim": cfg.embed_dim,
                      "max_count_of_one_id": max_dup,
                      "card": torch.cuda.get_device_name(0),
                      "gathers": out}, indent=1))


if __name__ == "__main__":
    main(*sys.argv[1:2])
