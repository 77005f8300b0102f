#!/usr/bin/env python3
"""Where gemma-2-2b's training step spends the card's time. Needs an
NVIDIA GPU.

    python3 probes/lm_step_profile.py [DTYPE]

trains gemma-2-2b at its published widths (``make_config()``; DTYPE
``bfloat16`` — the published type, the default — or ``float32``) for 3
steps of ``train_4k``'s 2 microbatches of 4,096 tokens with SCE
``exact``, as ``chip_smoke.py``'s phase 18 does, and records the third
step with ``torch.profiler`` (the ``mark`` hook of ``launch/train.py``
advances the profiler's schedule at each step's start). Prints one JSON
line: the step's device time by kernel (the 25 largest, ms and share),
the same summed into classes by kernel name (the port's kernels by
source, matrix products, elementwise and reductions, copies, the rest),
and the card's name and power limit.
"""
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CLASSES = (  # first match wins, on the kernel's name
    ("port: deep_tc (score slabs, SCE, full CE)", r"deep_tc"),
    ("port: mips_topk chain and sweeps", r"mips_|tau_|sample_kernel|sort"),
    ("port: sce_gather (fold, cotangent, dY sum)",
     r"fold_kernel|cotangent_kernel|dy_sum|sce_"),
    ("port: eval_fused", r"eval_"),
    ("matrix products (cuBLAS / cutlass)",
     r"gemm|Gemm|sm90_|cutlass|xmma|ampere|hopper|nvjet"),
    ("attention softmax / softcap elementwise",
     r"softmax|tanh"),
    ("elementwise and reductions",
     r"elementwise|vectorized|reduce|Reduce|unrolled|Loop|index|scatter|"
     r"gather|cat|fill|where|pow|mul|add|norm"),
    ("copies", r"[Mm]emcpy|[Mm]emset|copy"),
)


def main(dtype="bfloat16"):
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke as cs
    from repro_torch.configs.gemma2_2b import make_config
    from repro_torch.kernels import _build
    from repro_torch.launch.train import train

    _build.build_all()
    cfg = dataclasses.replace(make_config(), dtype=dtype)
    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=2, warmup=0, active=1))

    def mark(name):
        if name == "start":
            prof.step()

    with prof:
        train("gemma2-2b", cfg=cfg, batch=cs.LM_BATCH, seq_len=cs.LM_SEQ,
              steps=3, seed=0, sce_mode="exact", log_every=1,
              device="cuda", guard_policy="off", mark=mark)
        torch.cuda.synchronize()
        prof.step()
    per = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0) or getattr(
            e, "cuda_time_total", 0.0)
        if t > 0 and e.key and not e.key.startswith("ProfilerStep"):
            per[e.key] = per.get(e.key, 0.0) + t / 1e3
    total = sum(per.values())
    classes = dict.fromkeys([c for c, _ in CLASSES] + ["other"], 0.0)
    for name, ms in per.items():
        cls = next((c for c, pat in CLASSES if re.search(pat, name)),
                   "other")
        classes[cls] += ms
    top = sorted(per.items(), key=lambda kv: -kv[1])[:25]
    print(json.dumps({
        "dtype": dtype, "step_device_ms": round(total, 3),
        "classes": {k: [round(v, 3), round(v / total, 4)]
                    for k, v in classes.items()},
        "top": [[re.sub(r"\(.*", "", k)[:90], round(v, 3),
                 round(v / total, 4)] for k, v in top],
        "card": cs.smi()}), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:2])
