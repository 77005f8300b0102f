#!/usr/bin/env python3
"""gemma-2-2b's two bf16 trainers of two trees in turns: median step,
phases and peak memory. Needs an NVIDIA GPU.

    python3 probes/lm_turns.py TREE LABEL

imports ``chip_smoke.py`` and ``repro_torch`` from ``TREE`` (a checkout
of any commit, for example the parent unpacked with ``git archive`` into
``.benchrun/``), builds its kernels, takes the kernel guard's verdicts
(``chip_smoke.py``'s phase 3) and runs ``chip_smoke.py``'s phase 18
trainers at full width as published (bf16, 26 layers, 2 × 4,096 tokens a
step): ``lm_train_phase`` (SCE ``exact``, cap 30, 4 steps with the
token-rank evaluation) and ``lm_full_ce_phase`` (``ce_fused_linear``, 2
steps), then ``lm_serve_phase`` (the token-rank evaluation of 8,192
rows on fresh weights, prefill and decode), and prints ``LABEL {...}``
with each trainer's median step (host clock), its step phases (device
events) and its peak device memory in bytes (``max_memory_allocated``),
the evaluation's rows/s, and the card's name and power limit.
Run parent, change, change, parent in one call to compare.
"""
import json
import sys
from pathlib import Path


def main(tree, label):
    sys.path.insert(0, str(Path(tree) / "src"))
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from repro_torch import resolve_device
    from repro_torch.kernels import _build, guard

    dev = resolve_device("cuda")
    _build.build_all()
    # the guard's verdicts first, as chip_smoke.py's phase 3 takes them,
    # so that no canary launch falls inside the trainers' counts
    guard.set_policy(None)
    guard.run_conformance(device=dev, refresh=True)
    cfg = cs.lm_config()
    sce = cs.lm_train_phase(dev, cfg)
    ce = cs.lm_full_ce_phase(dev, cfg, sce)
    served = cs.lm_serve_phase(dev, cfg)
    keys = ("median_step_ms", "breakdown", "peak_bytes")
    print(label, json.dumps({"sce": {k: sce[k] for k in keys},
                             "full_ce": {k: ce[k] for k in keys},
                             "token_rank_rows_per_s":
                                 served["eval_rows_per_s"],
                             "card": cs.smi()}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
