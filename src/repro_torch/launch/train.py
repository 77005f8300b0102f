"""Trainer (port of ``repro/launch/train.py``: the seqrec, LM, CTR recsys
and GNN families).

``train("sasrec-sce", steps=N)`` draws random SASRec weights from
``seed``, streams ``SequenceDataset`` batches from ``Cursor(seed)`` and
steps ``launch/steps.py::make_seqrec_train_step`` (SCE on the kernel
path, guarded AdamW). ``train("bert4rec")`` does the same for BERT4Rec:
its batches hold the tokens only, and the step draws the cloze mask of
each microbatch from the run's generator before the loss's draw. The
seqrec step takes the microbatches of the arch's train shape at the
run's batch (bert4rec's ``train_batch``: 8, each ``batch / 8``
sequences; sasrec-sce's ``train_paper``: 1); the reference's trainer
runs one. ``train("gemma2-2b", seq_len=T)`` (and the other
registered LMs) does the same for a transformer LM: random weights
(``models/transformer.py``), ``batch`` full-length pseudo-language
sequences of ``T`` tokens a step, ``make_lm_train_step`` (the arch's
loss — SCE with the final softcap —, plus an MoE model's balance loss,
the arch's optimizer's guarded update written in place). At the length
of one of the arch's train shapes (4096: ``train_4k``) the step splits
the batch into that shape's microbatches (gemma-2: 2; granite: 8, so
``train("granite-moe-3b-a800m", cfg=make_config(), batch=8,
seq_len=4096)`` steps 8 microbatches of one sequence); the reference's
trainer runs every length as one microbatch. ``train("dcn-v2")`` (and
``dlrm-rm2``, ``xdeepfm``) streams ``ClickstreamDataset`` batches of
``batch`` rows (``dense``, ``sparse_ids``, ``labels``) from the config's
fields and steps ``make_recsys_train_step`` (BCE on the click logits,
guarded AdamW); ``train("schnet")`` steps ``make_gnn_train_step`` on
``batched_molecules`` batches of ``batch`` molecules of 10 nodes and 20
bonds (the reference's molecule regime) with the config's ``d_feat``.
As in the reference, the
mesh is always
``make_host_mesh(max_data=batch)`` over the ranks of the
``torch.distributed`` world (no process group, or one card: a (1, 1)
mesh), and ``sce_mode`` defaults to ``"exact"``: SCE runs as
``core/distributed_sce.py::sce_loss_sharded`` on that mesh, ``"union"``
in its union mode, ``"gspmd"`` as the global-bucket ``core/sce.py``
loss. Each rank steps its data shard of every global batch
(``dist.sharding.batch_rows``: with microbatches, its block of every
global microbatch). ``n_hosts`` emulates that many hosts, each drawing
its slice of the global batch through its own ``ShardedCursor``
(:func:`_host_batch`: bit for bit the one-host batch), and
``grad_compression="int8"`` runs the optimizer on int8 error-feedback
gradients (``optim/compression.py``). The default configuration is the arch's
smoke configuration, as in the reference; pass ``cfg=make_config()`` for
the paper's full width. It runs on ``cuda`` unless ``device="cpu"`` is
given, and raises when no device is given and CUDA is missing.

With ``eval_every=N`` it evaluates every N steps, as the reference
does, by the arch's protocol: the leave-one-out streaming evaluation
(``eval/harness.py::evaluate_streaming``, the ``eval_fused`` kernels on
the card) of ``eval_users`` held-out users drawn once from
``SequenceDataset.eval_batch(Cursor(seed))``, or for an LM the
token-rank evaluation (``evaluate_streaming_lm``) of every next-token
position of ``eval_users`` held-out sequences
(``SequenceDataset.heldout_batch``); each prints ``[eval] step N:
{...}``. With a ``model`` axis above 1 the evaluation runs on the mesh
(the sharded path of ``eval/harness.py``), as the reference's.

Fault tolerance, as in the reference (``checkpoint/manager.py``,
``launch/elastic.py``):

  * **auto-restore**: with ``ckpt_dir`` the newest checkpoint that passes
    verification (params, AdamW state, the step generator's state, the
    data cursor) is restored at start, printing ``[restore] resumed from
    step N``; a corrupt or torn newer step is skipped with a warning.
  * **async checkpoints** under the combined step (``ckpt_every``) and
    wall-clock (``ckpt_interval_s``) policy: a host snapshot, then a
    background write; ``keep_n`` checkpoints are kept.
  * **preemption**: SIGTERM / SIGINT finish the in-flight step, take a
    final blocking save and return ``preempted``; the CLI exits with 42
    (``elastic.EXIT_PREEMPTED``). ``kill -9`` needs no cooperation: the
    rename commit means the relaunch resumes from the last complete write.
  * **divergence guard** (``DivergenceGuard``): every batch carries its
    ``loss_cap`` (``inf`` for the first 8 healthy steps, then
    ``guard_factor`` × the running median); a step with a non-finite
    loss or gradient or a loss above the cap leaves the params and the
    optimizer state as they were and prints a ``[guard]`` strike line
    naming the kernel guard's tripped sentinels; ``max_strikes`` bad
    steps in a row restore the newest verified checkpoint with a
    reseeded data offset (``[guard] rolled back to verified step N``),
    or raise ``RuntimeError`` without ``ckpt_dir`` (the reference's
    behaviour) or an intact checkpoint. ``chaos_nan_at`` poisons the
    params with NaN the first time the loop reaches that step (the
    divergence drill); ``guard_policy`` (``--guard``) sets the kernel
    guard's policy (``kernels/guard``).
  * **straggler watchdog**: steps slower than ``watchdog`` × the median
    of the last ``WATCHDOG_WINDOW`` steps are logged; with
    ``skip_stragglers`` a data load that slow reuses the previous host
    batch.
  * ``metrics_file`` appends one JSON row per completed step (``step``,
    ``loss``, ``skipped``, ``grad_norm``, tripped ``sentinels``): the
    curve the kill drills compare step for step.

Under a ``torch.distributed`` world of several processes rank 0 writes
the checkpoints and every rank restores them; every rank reaches a
barrier before and after each save. Rank 0's save policy decides for
all (its clock is the one the last save reset), and a signal on any rank
stops all at once.
The state is replicated over the ranks, so a run saved on a world of 2
resumes on a world of 1, and the other way round.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec-sce \\
        --steps 4 --eval-every 2 --device cpu [--sce-mode union]
    # checkpoints: 4 steps save step 3; the same command with --steps 8
    # prints "[restore] resumed from step 3" and runs steps 4-7; a
    # SIGTERM drains (finishes the step, saves) and exits 42
    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec-sce \\
        --steps 4 --device cpu --ckpt-dir /tmp/ck --ckpt-every 4
    # the divergence drill: NaN params at step 5, strikes at 5 and 6; at
    # step 7 the RuntimeError, or with --ckpt-dir the rollback
    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec-sce \\
        --steps 10 --device cpu --guard strict --chaos-nan-at 5
    # two processes on the CPU (a (2, 1) mesh on gloo), int8 gradient
    # compression, two emulated hosts
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch sasrec-sce --steps 4 --device cpu --grad-compression int8 \\
        --n-hosts 2
    # the LM family: gemma-2's smoke config, 2 sequences of 32 tokens
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --steps 4 --batch 2 --seq-len 32 --eval-every 2 --device cpu
    # the CTR family (dlrm-rm2, xdeepfm alike) and SchNet
    PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 \\
        --steps 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch schnet \\
        --steps 4 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import (
    ClickDataConfig,
    ClickstreamDataset,
    Cursor,
    SeqDataConfig,
    SequenceDataset,
    ShardedCursor,
    batched_molecules,
)
from repro_torch.dist.sharding import batch_rows, world
from repro_torch.eval import evaluate_streaming, evaluate_streaming_lm
from repro_torch.kernels import guard as kguard
from repro_torch.launch.elastic import (
    EXIT_PREEMPTED,
    DivergenceGuard,
    PreemptionHandler,
    TrainState,
)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (
    RECSYS_INIT,
    make_gnn_train_step,
    make_lm_train_step,
    make_recsys_train_step,
    make_seqrec_train_step,
    n_microbatches,
)
from repro_torch.models import bert4rec, sasrec, schnet, transformer
from repro_torch.optim.optimizers import tree_map

# Step times the straggler watchdog's median reads: the most recent ones,
# so its cost a step stays flat however long the run.
WATCHDOG_WINDOW = 32
# The molecules of a SchNet run: the reference trainer's smoke regime.
GNN_NODES, GNN_EDGES = 10, 20
# What each family's step reads of a host batch.
BATCH_KEYS = {
    "lm": ("tokens", "targets", "valid"),
    "seqrec": ("tokens", "targets", "valid"),
    "recsys": ("dense", "sparse_ids", "labels"),
    "gnn": ("node_feats", "positions", "edge_index", "graph_ids", "targets"),
}


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


def _host_batch(data, cursor, n_hosts: int = 1):
    """The next global host batch at ``cursor`` → ``(batch, cursor)``.

    With ``n_hosts > 1`` each emulated host draws its own slice through
    its own :class:`ShardedCursor` and the batch is their concatenation:
    bit for bit the one-host batch for every ``n_hosts``, through the
    per-host code path. ``data`` may also be a function of the cursor
    alone (SchNet's molecules), which has no per-host path."""
    if callable(data):
        return data(cursor)
    if n_hosts == 1:
        return data.next_batch(cursor)
    parts = [data.next_batch_sharded(
        ShardedCursor(cursor, host_id=h, n_hosts=n_hosts))[0]
        for h in range(n_hosts)]
    return ({k: np.concatenate([p[k] for p in parts]) for k in parts[0]},
            cursor.advance())


def _agree(flag: bool) -> bool:
    """``flag`` raised on any rank of a world of several processes →
    True on every rank: a decision each rank could take alone (a
    signal), taken by all, so every rank reaches the same barriers."""
    if world()[1] == 1:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _lead_decides(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank: a save is due by the writer's own
    policy (only rank 0 saves, so only its clock was reset by the last
    save), and every rank reaches the same barriers."""
    if world()[1] == 1:
        return flag
    t = torch.tensor([int(flag)])
    dist.broadcast(t, src=0)
    return bool(t.item())


def _barrier() -> None:
    if world()[1] > 1:
        dist.barrier()


def train(arch_name: str, *, cfg=None, steps: int = 50, batch: int = 8,
          seq_len: int = 32, seed: int = 0, sce_mode: str = "exact",
          log_every: int = 10,
          eval_every: int = 0, eval_users: int = 128, device=None,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          ckpt_interval_s: Optional[float] = None, keep_n: int = 3,
          watchdog: float = 5.0, skip_stragglers: bool = False,
          metrics_file: Optional[str] = None, max_strikes: int = 3,
          guard_factor: float = 100.0, chaos_nan_at: Optional[int] = None,
          guard_policy: Optional[str] = None, mark=None,
          train_loss: Optional[str] = None,
          grad_compression: Optional[str] = None,
          n_hosts: int = 1) -> Dict[str, Any]:
    """Train ``arch_name`` for ``steps`` steps of ``batch`` sequences (the
    global batch: each rank of the mesh steps its data shard of it) —
    a seqrec model's of ``cfg.max_len`` items, an LM's of ``seq_len`` tokens.

    ``mark``, when given, is called with ``"start"`` once a step's host
    batch is ready, with ``"h2d"`` once it is on the device, then with
    the step's own phases (``make_seqrec_train_step``,
    ``make_lm_train_step``): a hook to time each phase of the trainer's
    steps.

    ``eval_every > 0`` evaluates ``eval_users`` held-out users (an LM:
    sequences) after every ``eval_every``-th step (see the module
    docstring); a step's time is taken before its evaluation.

    ``ckpt_dir`` turns on checkpoints (see the module docstring):
    ``ckpt_every`` / ``ckpt_interval_s`` are the save policy,
    ``keep_n`` the checkpoints kept (0 = all). ``watchdog`` logs steps
    slower than that multiple of the median of the last
    ``WATCHDOG_WINDOW`` steps; with
    ``skip_stragglers`` a data load slower than that reuses the previous
    host batch. ``metrics_file`` appends one JSON row per completed step
    (``step``, ``loss``, ``skipped``, ``grad_norm``, and the tripped
    ``sentinels`` when any).

    A CTR arch takes ``batch`` clickstream rows a step and SchNet
    ``batch`` molecules (see the module docstring); neither has an eval
    protocol, so ``eval_every`` warns and evaluates nothing, as in the
    reference. SchNet takes no ``n_hosts`` above 1 (``ValueError``, as
    the reference), no ``grad_compression`` (``ValueError``), and no data
    axis above 1 (``NotImplementedError``).

    ``max_strikes`` / ``guard_factor`` configure the divergence guard;
    ``chaos_nan_at`` is the fault-injection hook of the divergence drill:
    the first time the loop reaches that step, the params are multiplied
    by NaN, which the guard must catch (update skipped on the device,
    strikes). The ``max_strikes``-th bad step in a row rolls back to the
    newest verified checkpoint, or raises ``RuntimeError`` without
    ``ckpt_dir`` or an intact checkpoint. ``guard_policy`` (``off`` /
    ``warn`` / ``strict``) sets the process-wide kernel-guard policy.
    ``train_loss`` replaces the arch's own loss (a registry name, e.g.
    ``"ce_fused_linear"``: the full-CE baseline of an SCE arch).
    ``grad_compression`` (``"int8"`` or None) and ``n_hosts`` (emulated
    hosts; ``batch`` must divide) are the module docstring's.

    Returns ``first_loss``, ``final_loss``, ``steps`` (steps run in this
    call, a rolled-back stretch counted again), ``mean_step_s`` (host
    clock per step, each ending in one read of the step's metrics, so
    the device work is inside), ``skipped_steps`` (steps the guard did
    not count as ok), ``rollbacks``, and per step run ``losses``,
    ``step_s``, ``loss_caps`` (the cap each batch carried) and
    ``sentinels`` (the kernel guard's counts, empty under policy
    ``off``); after SIGTERM / SIGINT also ``preempted`` and
    ``preempt_step``; with evaluation ``eval``, the last evaluation's
    metrics (``hr@k`` / ``ndcg@k`` / ``cov@k``; an LM's ``hr@k`` /
    ``ndcg@k`` / ``mean_rank`` / ``loss`` / ``n_tokens``).
    """
    if guard_policy is not None:
        kguard.set_policy(guard_policy)
    device = resolve_device(device)
    arch = get_arch(arch_name)
    if train_loss is not None:
        arch = dataclasses.replace(arch, train_loss=train_loss)
    family = arch.family
    lm = family == "lm"
    if family == "gnn" and n_hosts > 1:
        raise ValueError("--n-hosts emulation needs a sharded dataset; "
                         "the gnn molecule stream has none")
    if family == "gnn" and grad_compression is not None:
        raise ValueError("SchNet's step takes no gradient compression")
    if n_hosts < 1 or batch % n_hosts:
        raise ValueError(f"batch {batch} not divisible by n_hosts {n_hosts}")
    cfg = cfg if cfg is not None else arch.make_smoke_config()
    if family == "recsys":
        shape = ShapeSpec(next(s.name for s in arch.shapes
                               if s.kind == "train"), "train",
                          {"batch": batch})
        data = ClickstreamDataset(ClickDataConfig(
            vocab_sizes=cfg.vocab_sizes, batch_size=batch,
            n_dense=getattr(cfg, "n_dense", 1),
        ))
    elif family == "gnn":
        dims = {"batch": batch, "n_nodes": GNN_NODES, "n_edges": GNN_EDGES,
                "d_feat": cfg.d_feat}
        shape = ShapeSpec("molecule", "train", dims)

        def data(cursor):
            mols, cur = batched_molecules(
                cursor, n_mols=batch, nodes_per_mol=GNN_NODES,
                edges_per_mol=GNN_EDGES, d_feat=cfg.d_feat)
            mols.pop("n_graphs")  # the shape's batch
            return mols, cur
    elif lm:
        # A run at the length of one of the arch's train shapes takes its
        # name, and with it the arch's microbatches for it (gemma-2's
        # train_4k: 2); any other length is a smoke run of one.
        name = next((s.name for s in arch.shapes if s.kind == "train"
                     and s.dims.get("seq_len") == seq_len), "train_smoke")
        shape = ShapeSpec(name, "train",
                          {"global_batch": batch, "seq_len": seq_len})
        data = SequenceDataset(SeqDataConfig(
            n_items=cfg.vocab, seq_len=seq_len, batch_size=batch,
            min_len_frac=1.0,
        ))
    else:
        # The arch's train shape names the run, so the step takes that
        # shape's microbatches (bert4rec's train_batch: 8; sasrec-sce's
        # train_paper: 1) at the run's batch.
        name = next(s.name for s in arch.shapes if s.kind == "train")
        shape = ShapeSpec(name, "train", {"batch": batch})
        data = SequenceDataset(SeqDataConfig(
            n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=batch,
        ))
    mesh = make_host_mesh(max_data=batch)
    if not mesh.member:
        raise ValueError(f"rank {world()[0]} is outside the {mesh.shape} "
                         f"mesh: the world must fit a data axis dividing "
                         f"batch {batch}")
    lead = world()[0] == 0
    # BERT4Rec masks inside the step: its batches carry the tokens only.
    batch_keys = (("tokens",) if not getattr(cfg, "causal", True)
                  else BATCH_KEYS[family])
    if lm:
        step_fn, (opt_init, _), _ = make_lm_train_step(
            arch, cfg, shape, mesh=mesh, sce_mode=sce_mode,
            grad_compression=grad_compression)
        params = transformer.init_params(cfg, seed=seed, device=device)
    elif family == "recsys":
        step_fn, (opt_init, _) = make_recsys_train_step(
            arch, cfg, shape, mesh=mesh, grad_compression=grad_compression)
        params = RECSYS_INIT[arch.name](cfg, seed=seed, device=device)
    elif family == "gnn":
        step_fn, (opt_init, _) = make_gnn_train_step(arch, cfg, shape,
                                                     mesh=mesh)
        params = schnet.init_params(cfg, seed=seed, device=device)
    else:
        step_fn, (opt_init, _), _ = make_seqrec_train_step(
            arch, cfg, shape, mesh=mesh, sce_mode=sce_mode,
            grad_compression=grad_compression)
        init = sasrec.init_params if cfg.causal else bert4rec.init_params
        params = init(cfg, seed=seed, device=device)
    # this rank's rows: its block of every global microbatch (a graph
    # batch, on one rank only, is whole)
    rows = (slice(None) if family == "gnn"
            else batch_rows(mesh, batch, n_microbatches(arch, shape, mesh)))
    state = TrainState(
        params=params, opt_state=opt_init(params),
        generator=torch.Generator(device=device).manual_seed(seed),
        cursor=Cursor(seed=seed), step=-1,
    )
    mgr = (CheckpointManager(ckpt_dir, keep_n=keep_n,
                             save_every_steps=ckpt_every,
                             save_interval_seconds=ckpt_interval_s)
           if ckpt_dir else None)

    def restore_or(state):
        """The newest verified checkpoint, or ``state`` unchanged."""
        last, tree = mgr.restore_latest(device=device)
        if last is None:
            return state, None
        restored = TrainState.from_ckpt(
            tree, opt_template=state.opt_state, device=device)
        if lead:
            print(f"[restore] resumed from step {last}")
        return restored, last

    if mgr is not None:
        state, _ = restore_or(state)

    protocol = "token-rank" if lm else "leave-one-out"
    do_eval = eval_every > 0 and arch.eval_protocol == protocol
    if eval_every > 0 and not do_eval:
        print(f"[eval] WARNING: --eval-every {eval_every} requested, but "
              f"arch {arch.name!r} has the eval protocol "
              f"{arch.eval_protocol!r}, not {protocol!r} — in-loop "
              f"evaluation is SKIPPED")
    eval_metrics: Dict[str, float] = {}
    if do_eval and lm:
        eval_batch, _ = SequenceDataset(SeqDataConfig(
            n_items=cfg.vocab, seq_len=seq_len, batch_size=eval_users,
            min_len_frac=1.0,
        )).heldout_batch(Cursor(seed=seed))
    elif do_eval:
        eval_batch, _ = SequenceDataset(SeqDataConfig(
            n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=eval_users,
        )).eval_batch(Cursor(seed=seed))
    evaluate = evaluate_streaming_lm if lm else evaluate_streaming
    eval_mesh = mesh if mesh.shape["model"] > 1 else None

    guard = DivergenceGuard(max_strikes=max_strikes,
                            cap_factor=guard_factor)
    metrics_fh = open(metrics_file, "a") if metrics_file else None
    chaos_fired = False

    def record(step, loss, skipped, grad_norm, sentinels):
        if metrics_fh is None:
            return
        row = {"step": step, "loss": loss, "skipped": skipped,
               "grad_norm": grad_norm}
        if sentinels:
            row["sentinels"] = sentinels
        metrics_fh.write(json.dumps(row) + "\n")
        metrics_fh.flush()

    def save_state(blocking: bool):
        _barrier()
        if lead:  # the state is replicated: one rank writes it
            mgr.save(state.step, state.to_ckpt(n_hosts=n_hosts),
                     blocking=blocking)
        _barrier()

    losses, times, caps, sentinel_log = [], [], [], []
    recent = deque(maxlen=WATCHDOG_WINDOW)
    median_s = None  # the watchdog's median, taken once a step
    skipped_steps = 0
    preempted = False
    prev_batch = None
    try:
        with PreemptionHandler() as preemption:
            step = state.step + 1
            while step < steps:
                if _agree(preemption.preempted):
                    preempted = True
                    break
                if step == chaos_nan_at and not chaos_fired:
                    chaos_fired = True  # once: a rollback repeats steps
                    if lead:
                        print(f"[chaos] step {step}: poisoning params "
                              f"with NaN")
                    state.params = tree_map(
                        lambda p: p * float("nan")
                        if p.is_floating_point() else p, state.params)
                t0 = time.perf_counter()
                host_batch, new_cursor = _host_batch(data, state.cursor,
                                                     n_hosts)
                t_data = time.perf_counter() - t0
                # Straggler mitigation: a stalled data load reuses the
                # previous batch (bounded staleness) instead of blocking.
                if (skip_stragglers and prev_batch is not None
                        and median_s is not None
                        and t_data > watchdog * median_s):
                    host_batch = prev_batch
                    print(f"[watchdog] step {step}: slow input shard "
                          f"({t_data:.2f}s) — reusing previous batch")
                    new_cursor = state.cursor
                else:
                    prev_batch = host_batch
                if mark:
                    mark("start")
                dev_batch = to_device(
                    {k: v[rows] for k, v in host_batch.items()
                     if k in batch_keys}, device)
                cap = guard.loss_cap()
                dev_batch["loss_cap"] = torch.full(
                    (), cap, dtype=torch.float32, device=device)
                if mark:
                    mark("h2d")
                state.params, state.opt_state, metrics = step_fn(
                    state.params, state.opt_state, dev_batch,
                    generator=state.generator, mark=mark,
                )
                loss, skipped, grad_norm, counts = _host_metrics(metrics)
                state.cursor = new_cursor
                state.step = step
                dt = time.perf_counter() - t0
                losses.append(loss)
                times.append(dt)
                recent.append(dt)
                median_s = statistics.median(recent)
                caps.append(float(np.float32(cap)))  # as the batch carries
                sentinel_log.append(counts)
                tripped = {k: v for k, v in counts.items() if v}
                record(step, loss, skipped, grad_norm, tripped)

                verdict = guard.observe(loss, skipped=skipped)
                if verdict != "ok":
                    skipped_steps += 1
                    blame = (f" (sentinels: "
                             f"{kguard.describe_sentinels(counts)})"
                             if tripped else "")
                    if lead:
                        print(f"[guard] step {step}: loss {loss:.4g} "
                              f"grad_norm {grad_norm:.4g} — update skipped "
                              f"(strike {guard.strikes or guard.max_strikes}"
                              f"/{guard.max_strikes}){blame}")
                if verdict == "rollback":
                    if mgr is None:
                        raise RuntimeError(
                            f"diverged for {guard.max_strikes} consecutive "
                            f"steps at step {step} and no --ckpt-dir to "
                            f"roll back to")
                    mgr.wait()  # an in-flight async save must land first
                    _barrier()
                    rolled, last = restore_or(state)
                    if last is None:
                        raise RuntimeError("diverged and no intact "
                                           "checkpoint to roll back to")
                    state = rolled
                    state.cursor = guard.reseed(state.cursor)
                    if lead:
                        offset = guard.reseed_stride * guard.rollbacks
                        print(f"[guard] rolled back to verified step "
                              f"{last} (rollback #{guard.rollbacks}, data "
                              f"offset +{offset})")
                    step = state.step + 1
                    continue

                if dt > watchdog * median_s:
                    print(f"[watchdog] step {step} took {dt:.2f}s (median "
                          f"{median_s:.2f}s)")
                if lead and log_every and step % log_every == 0:
                    print(f"step {step:5d}  loss {loss:.4f}  "
                          f"{dt * 1e3:.0f} ms")
                if do_eval and (step + 1) % eval_every == 0:
                    eval_metrics = evaluate(state.params, cfg, eval_batch,
                                            mesh=eval_mesh)
                    shown = {k: round(v, 4) for k, v in eval_metrics.items()}
                    if lead:
                        print(f"[eval] step {step}: {shown}")
                if mgr is not None and _lead_decides(mgr.should_save(step)):
                    save_state(blocking=False)
                step += 1
            if not preempted and _agree(preemption.preempted):
                preempted = True  # the signal came during the last step

        if mgr is not None:
            mgr.wait()
            if preempted:
                # A final blocking save of the exact current state, so
                # the relaunch loses no completed step.
                save_state(blocking=True)
                print(f"[preempt] state saved at step {state.step}; exit "
                      f"{EXIT_PREEMPTED} to request relaunch")
    finally:
        if metrics_fh is not None:
            metrics_fh.close()
    out = {
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "steps": len(losses),
        "mean_step_s": statistics.mean(times) if times else None,
        "skipped_steps": skipped_steps,
        "rollbacks": guard.rollbacks,
        "losses": losses,
        "step_s": times,
        "loss_caps": caps,
        "sentinels": sentinel_log,
    }
    if preempted:
        out["preempted"] = True
        out["preempt_step"] = state.step
    if eval_metrics:
        out["eval"] = eval_metrics
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32,
                    help="tokens a sequence (the LM archs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sce-mode", default="exact",
                    choices=["exact", "union", "gspmd"])
    ap.add_argument("--log-every", type=int, default=10,
                    help="print a progress line every N steps")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="run the streaming unsampled evaluation every N "
                         "steps (0 = never)")
    ap.add_argument("--eval-users", type=int, default=128,
                    help="held-out sequences per evaluation (an LM: every "
                         "next-token position of each is an eval row)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--ckpt-dir",
                    help="checkpoint directory: resume from its newest "
                         "verified step, save into it")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="step-based save interval")
    ap.add_argument("--ckpt-interval-s", type=float,
                    help="wall-clock save interval in seconds (with "
                         "--ckpt-every: whichever fires first)")
    ap.add_argument("--keep-n", type=int, default=3,
                    help="checkpoints kept (0 = all)")
    ap.add_argument("--skip-stragglers", action="store_true",
                    help="reuse the previous batch when a data load is "
                         "slower than 5x the median step")
    ap.add_argument("--metrics-file",
                    help="append one JSON line per completed step (the "
                         "drills' loss curve)")
    ap.add_argument("--max-strikes", type=int, default=3,
                    help="consecutive bad steps before rolling back to "
                         "the last verified checkpoint (without one: "
                         "RuntimeError)")
    ap.add_argument("--guard-factor", type=float, default=100.0,
                    help="divergence cap = factor x running median loss")
    ap.add_argument("--chaos-nan-at", type=int,
                    help="fault injection: poison params with NaN at this "
                         "step once (divergence drill)")
    ap.add_argument("--guard", choices=list(kguard.POLICIES),
                    help="kernel-guard policy (default: REPRO_GUARD or "
                         "'warn'): preflight, conformance canaries, "
                         "numerics sentinels")
    ap.add_argument("--grad-compression", choices=["int8"],
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--n-hosts", type=int, default=1,
                    help="emulated hosts: the batch is the concatenation "
                         "of per-host ShardedCursor slices, the same "
                         "global stream for any value")
    args = ap.parse_args()
    # Under torchrun (WORLD_SIZE > 1) join its group: gloo on the CPU.
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if launched:
        if resolve_device(args.device).type != "cpu":
            raise NotImplementedError(
                "a run over several processes runs on the CPU only "
                "(--device cpu): NCCL puts one rank on each card, and the "
                "4-chip cell comes first (ROADMAP.md queue 1 item 14)")
        dist.init_process_group("gloo", init_method="env://")
    try:
        out = train(args.arch, steps=args.steps, batch=args.batch,
                    seq_len=args.seq_len, seed=args.seed,
                    sce_mode=args.sce_mode,
                    log_every=args.log_every, eval_every=args.eval_every,
                    eval_users=args.eval_users, device=args.device,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    ckpt_interval_s=args.ckpt_interval_s,
                    keep_n=args.keep_n, skip_stragglers=args.skip_stragglers,
                    metrics_file=args.metrics_file,
                    max_strikes=args.max_strikes,
                    guard_factor=args.guard_factor,
                    chaos_nan_at=args.chaos_nan_at, guard_policy=args.guard,
                    grad_compression=args.grad_compression,
                    n_hosts=args.n_hosts)
        if world()[0] == 0:
            print(json.dumps(out))
    finally:
        if launched:
            dist.destroy_process_group()
    if out.get("preempted"):
        sys.exit(EXIT_PREEMPTED)


if __name__ == "__main__":
    main()
