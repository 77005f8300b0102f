"""Trainer (port of the seqrec subset of ``repro/launch/train.py``).

``train("sasrec-sce", steps=N)`` draws random SASRec weights from
``seed``, streams ``SequenceDataset`` batches from ``Cursor(seed)`` and
steps ``launch/steps.py::make_seqrec_train_step`` (SCE on the kernel
path, guarded AdamW). As in the reference, the mesh is always
``make_host_mesh(max_data=batch)`` over the ranks of the
``torch.distributed`` world (no process group, or one card: a (1, 1)
mesh), and ``sce_mode`` defaults to ``"exact"``: SCE runs as
``core/distributed_sce.py::sce_loss_sharded`` on that mesh, ``"union"``
in its union mode, ``"gspmd"`` as the global-bucket ``core/sce.py``
loss. Each rank steps its data shard of every global batch
(``dist.sharding.batch_slice``). The default configuration is the arch's
smoke configuration, as in the reference; pass ``cfg=make_config()`` for
the paper's full width. It runs on ``cuda`` unless ``device="cpu"`` is
given, and raises when no device is given and CUDA is missing.

With ``eval_every=N`` it evaluates every N steps, as the reference
does: the leave-one-out streaming evaluation
(``eval/harness.py::evaluate_streaming``, the ``eval_fused`` kernels on
the card) of ``eval_users`` held-out users drawn once from
``SequenceDataset.eval_batch(Cursor(seed))``; each prints
``[eval] step N: {...}``.

The divergence guard (``launch/elastic.py::DivergenceGuard``) runs as
in the reference: every batch carries its ``loss_cap`` (``inf`` for the
first 8 healthy steps, then ``guard_factor`` × the running median), a
step with a non-finite loss or gradient or a loss above the cap leaves
the params and the optimizer state as they were and prints a ``[guard]``
strike line naming the kernel guard's tripped sentinels, and
``max_strikes`` bad steps in a row raise ``RuntimeError`` (the
reference's behaviour without ``--ckpt-dir``). ``guard_policy``
(``--guard``) sets the kernel guard's policy (``kernels/guard``);
``chaos_nan_at`` poisons the params with NaN once at that step (the
divergence drill).

Left out, with their ROADMAP.md queue: checkpoints, preemption and the
divergence guard's checkpointed rollback (queue 1 item 10), the LM's
token-rank evaluation (item 12), the sharded evaluation, ``--n-hosts``
emulation and gradient compression (item 14).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec-sce \\
        --steps 4 --eval-every 2 --device cpu [--sce-mode union]
    # the divergence drill: NaN params at step 5, strikes at 5 and 6, the
    # RuntimeError at step 7
    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec-sce \\
        --steps 10 --device cpu --guard strict --chaos-nan-at 5
    # two processes on the CPU (a (2, 1) mesh on gloo)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch sasrec-sce --steps 4 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
from repro_torch.dist.sharding import batch_slice, world
from repro_torch.eval import evaluate_streaming
from repro_torch.kernels import guard as kguard
from repro_torch.launch.elastic import DivergenceGuard
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_seqrec_train_step
from repro_torch.models import sasrec
from repro_torch.optim.optimizers import tree_map


def to_device(host_batch, device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in host_batch.items()}


def _host_metrics(metrics):
    """``(loss, skipped, grad_norm, sentinels)`` of one step on the host,
    in ONE device→host transfer: the scalars and the sentinel counts are
    stacked on the device first (f64 holds the int32 counts exactly)."""
    names = sorted(metrics.get("sentinels", {}))
    row = torch.stack(
        [metrics[k].detach().to(torch.float64)
         for k in ("loss", "skipped", "grad_norm")]
        + [metrics["sentinels"][n].to(torch.float64) for n in names]
    ).tolist()
    return (row[0], bool(row[1]), row[2],
            {n: int(v) for n, v in zip(names, row[3:])})


def train(arch_name: str, *, cfg=None, steps: int = 50, batch: int = 8,
          seed: int = 0, sce_mode: str = "exact", log_every: int = 10,
          eval_every: int = 0, eval_users: int = 128, device=None,
          max_strikes: int = 3, guard_factor: float = 100.0,
          chaos_nan_at: Optional[int] = None,
          guard_policy: Optional[str] = None, mark=None) -> Dict[str, Any]:
    """Train ``arch_name`` for ``steps`` steps of ``batch`` sequences (the
    global batch: each rank of the mesh steps its data shard of it).

    ``mark``, when given, is called with ``"start"`` once a step's host
    batch is ready, with ``"h2d"`` once it is on the device, then with
    the step's own phases (``make_seqrec_train_step``): a hook to time
    each phase of the trainer's steps.

    ``eval_every > 0`` evaluates ``eval_users`` held-out users after
    every ``eval_every``-th step (see the module docstring); a step's
    time is taken before its evaluation.

    ``max_strikes`` / ``guard_factor`` configure the divergence guard;
    ``chaos_nan_at`` is the fault-injection hook of the divergence drill:
    at that step the params are multiplied by NaN *once*, which the guard
    must catch (update skipped on the device, strikes) — with no
    checkpoint to roll back to, the ``max_strikes``-th bad step in a row
    raises ``RuntimeError``. ``guard_policy`` (``off`` / ``warn`` /
    ``strict``) sets the process-wide kernel-guard policy.

    Returns ``first_loss``, ``final_loss``, ``steps``, ``mean_step_s``
    (host clock per step, each ending in one read of the step's metrics,
    so the device work is inside), ``skipped_steps`` (steps the guard
    did not count as ok), and per step ``losses`` (the curve the
    reference writes to ``--metrics-file``), ``step_s``, ``loss_caps``
    (the cap each batch carried) and ``sentinels`` (the kernel guard's
    counts, empty under policy ``off``); with evaluation also ``eval``,
    the last evaluation's metrics (``hr@k`` / ``ndcg@k`` / ``cov@k``).
    """
    if guard_policy is not None:
        kguard.set_policy(guard_policy)
    device = resolve_device(device)
    arch = get_arch(arch_name)
    if arch.family != "seqrec":
        raise NotImplementedError(f"{arch.family} training is not ported")
    cfg = cfg if cfg is not None else arch.make_smoke_config()
    shape = ShapeSpec("train_smoke", "train", {"batch": batch})
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=batch,
    ))
    mesh = make_host_mesh(max_data=batch)
    if not mesh.member:
        raise ValueError(f"rank {world()[0]} is outside the {mesh.shape} "
                         f"mesh: the world must fit a data axis dividing "
                         f"batch {batch}")
    rows = batch_slice(mesh, batch)
    lead = world()[0] == 0
    step_fn, (opt_init, _), _ = make_seqrec_train_step(
        arch, cfg, shape, mesh=mesh, sce_mode=sce_mode)
    params = sasrec.init_params(cfg, seed=seed, device=device)
    opt_state = opt_init(params)
    generator = torch.Generator(device=device).manual_seed(seed)
    cursor = Cursor(seed=seed)

    do_eval = eval_every > 0 and arch.eval_protocol == "leave-one-out"
    if eval_every > 0 and not do_eval:
        print(f"[eval] WARNING: --eval-every {eval_every} requested, but "
              f"arch {arch.name!r} has the eval protocol "
              f"{arch.eval_protocol!r}, not 'leave-one-out' — in-loop "
              f"evaluation is SKIPPED")
    eval_metrics: Dict[str, float] = {}
    if do_eval:
        eval_batch, _ = SequenceDataset(SeqDataConfig(
            n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=eval_users,
        )).eval_batch(Cursor(seed=seed))

    guard = DivergenceGuard(max_strikes=max_strikes,
                            cap_factor=guard_factor)
    losses, times, caps, sentinel_log = [], [], [], []
    skipped_steps = 0
    for step in range(steps):
        if step == chaos_nan_at:  # once: steps never repeat without rollback
            if lead:
                print(f"[chaos] step {step}: poisoning params with NaN")
            params = tree_map(lambda p: p * float("nan")
                              if p.is_floating_point() else p, params)
        t0 = time.perf_counter()
        host_batch, cursor = data.next_batch(cursor)
        if mark:
            mark("start")
        dev_batch = to_device({k: v[rows] for k, v in host_batch.items()},
                              device)
        cap = guard.loss_cap()
        dev_batch["loss_cap"] = torch.full((), cap, dtype=torch.float32,
                                           device=device)
        if mark:
            mark("h2d")
        params, opt_state, metrics = step_fn(
            params, opt_state, dev_batch, generator=generator, mark=mark,
        )
        loss, skipped, grad_norm, counts = _host_metrics(metrics)
        dt = time.perf_counter() - t0
        losses.append(loss)
        times.append(dt)
        caps.append(float(np.float32(cap)))  # as the batch carries it
        sentinel_log.append(counts)
        verdict = guard.observe(loss, skipped=skipped)
        if verdict != "ok":
            skipped_steps += 1
            blame = (f" (sentinels: {kguard.describe_sentinels(counts)})"
                     if any(counts.values()) else "")
            if lead:
                print(f"[guard] step {step}: loss {loss:.4g} grad_norm "
                      f"{grad_norm:.4g} — update skipped (strike "
                      f"{guard.strikes or guard.max_strikes}"
                      f"/{guard.max_strikes}){blame}")
        if verdict == "rollback":
            raise RuntimeError(
                f"diverged for {guard.max_strikes} consecutive steps at "
                f"step {step} and no --ckpt-dir to roll back to")
        if lead and log_every and step % log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  {dt * 1e3:.0f} ms")
        if do_eval and (step + 1) % eval_every == 0:
            eval_metrics = evaluate_streaming(params, cfg, eval_batch)
            shown = {k: round(v, 4) for k, v in eval_metrics.items()}
            if lead:
                print(f"[eval] step {step}: {shown}")
    out = {
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "steps": len(losses),
        "mean_step_s": statistics.mean(times) if times else None,
        "skipped_steps": skipped_steps,
        "losses": losses,
        "step_s": times,
        "loss_caps": caps,
        "sentinels": sentinel_log,
    }
    if eval_metrics:
        out["eval"] = eval_metrics
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sce-mode", default="exact",
                    choices=["exact", "union", "gspmd"])
    ap.add_argument("--log-every", type=int, default=10,
                    help="print a progress line every N steps")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="run the streaming unsampled evaluation every N "
                         "steps (0 = never)")
    ap.add_argument("--eval-users", type=int, default=128,
                    help="held-out sequences per evaluation")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--max-strikes", type=int, default=3,
                    help="consecutive bad steps before the divergence "
                         "guard gives up (no checkpoint: RuntimeError)")
    ap.add_argument("--guard-factor", type=float, default=100.0,
                    help="divergence cap = factor x running median loss")
    ap.add_argument("--chaos-nan-at", type=int,
                    help="fault injection: poison params with NaN at this "
                         "step once (divergence drill)")
    ap.add_argument("--guard", choices=list(kguard.POLICIES),
                    help="kernel-guard policy (default: REPRO_GUARD or "
                         "'warn'): preflight, conformance canaries, "
                         "numerics sentinels")
    args = ap.parse_args()
    # Under torchrun (WORLD_SIZE > 1) join its group: gloo on the CPU.
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if launched:
        if resolve_device(args.device).type != "cpu":
            raise NotImplementedError("a run over several processes is "
                                      "ported on the CPU only (--device cpu)")
        dist.init_process_group("gloo", init_method="env://")
    try:
        out = train(args.arch, steps=args.steps, batch=args.batch,
                    seed=args.seed, sce_mode=args.sce_mode,
                    log_every=args.log_every, eval_every=args.eval_every,
                    eval_users=args.eval_users, device=args.device,
                    max_strikes=args.max_strikes,
                    guard_factor=args.guard_factor,
                    chaos_nan_at=args.chaos_nan_at, guard_policy=args.guard)
        if world()[0] == 0:
            print(json.dumps(out))
    finally:
        if launched:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
