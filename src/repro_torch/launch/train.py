"""Single-device trainer (port of the single-device subset of
``repro/launch/train.py``).

``train("sasrec-sce", steps=N)`` draws random SASRec weights from
``seed``, streams ``SequenceDataset`` batches from ``Cursor(seed)`` and
steps ``launch/steps.py::make_seqrec_train_step`` (SCE on the kernel
path, guarded AdamW). The default configuration is the arch's smoke
configuration, as in the reference; pass ``cfg=make_config()`` for the
paper's full width. It runs on ``cuda`` unless ``device="cpu"`` is
given, and raises when no device is given and CUDA is missing.

Left out, with their ROADMAP.md queue: checkpoints, preemption and the
divergence guard's rollback (queue 1 item 10), the kernel guard (item
11), in-loop evaluation (slice 3), the mesh and host emulation (queue
14). The step's own guard still holds: a step with a non-finite loss or
gradient leaves the params and the optimizer state as they were.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec-sce \\
        --steps 3 --device cpu
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
from repro_torch.launch.steps import make_seqrec_train_step
from repro_torch.models import sasrec


def to_device(host_batch, device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in host_batch.items()}


def train(arch_name: str, *, cfg=None, steps: int = 50, batch: int = 8,
          seed: int = 0, log_every: int = 10, device=None,
          mark=None) -> Dict[str, Any]:
    """Train ``arch_name`` for ``steps`` steps of ``batch`` sequences.

    ``mark``, when given, is called with ``"start"`` once a step's host
    batch is ready, with ``"h2d"`` once it is on the device, then with
    the step's own phases (``make_seqrec_train_step``): a hook to time
    each phase of the trainer's steps.

    Returns ``first_loss``, ``final_loss``, ``steps``, ``mean_step_s``
    (host clock per step, each ending in a read of the loss, so the
    device work is inside), ``skipped_steps``, and per step ``losses``
    (the curve the reference writes to ``--metrics-file``) and
    ``step_s``.
    """
    device = resolve_device(device)
    arch = get_arch(arch_name)
    if arch.family != "seqrec":
        raise NotImplementedError(f"{arch.family} training is not ported")
    cfg = cfg if cfg is not None else arch.make_smoke_config()
    shape = ShapeSpec("train_smoke", "train", {"batch": batch})
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=batch,
    ))
    step_fn, (opt_init, _), _ = make_seqrec_train_step(arch, cfg, shape)
    params = sasrec.init_params(cfg, seed=seed, device=device)
    opt_state = opt_init(params)
    generator = torch.Generator(device=device).manual_seed(seed)
    cursor = Cursor(seed=seed)

    losses, times = [], []
    skipped_steps = 0
    for step in range(steps):
        t0 = time.perf_counter()
        host_batch, cursor = data.next_batch(cursor)
        if mark:
            mark("start")
        dev_batch = to_device(host_batch, device)
        if mark:
            mark("h2d")
        params, opt_state, metrics = step_fn(
            params, opt_state, dev_batch, generator=generator, mark=mark,
        )
        loss = float(metrics["loss"])
        skipped = bool(metrics["skipped"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        times.append(dt)
        if skipped:
            skipped_steps += 1
            print(f"[guard] step {step}: loss {loss:.4g} grad_norm "
                  f"{float(metrics['grad_norm']):.4g} — update skipped")
        if log_every and step % log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  {dt * 1e3:.0f} ms")
    return {
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "steps": len(losses),
        "mean_step_s": statistics.mean(times) if times else None,
        "skipped_steps": skipped_steps,
        "losses": losses,
        "step_s": times,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10,
                    help="print a progress line every N steps")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    out = train(args.arch, steps=args.steps, batch=args.batch,
                seed=args.seed, log_every=args.log_every, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
