"""One rank of the port's multi-process CPU tests: joins a ``gloo`` group
through a rendezvous file, runs what ``spec.json`` asks and writes its
results to ``out<rank>.npz``. It imports torch, numpy and ``repro_torch``
only (never JAX); the JAX oracles run in the pytest process.

    python tests/_dist_workers.py RANK WORLD DIR

``DIR`` holds ``spec.json`` and ``inputs.npz`` (see
``tests/test_torch_distributed_sce.py``). Every rank of the world runs
every task in the same order, so the process groups each task builds
(``new_group``) match across ranks.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed_sce import sce_loss_sharded
from repro_torch.core.sce import SCEConfig
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import (
    batch_slice,
    catalog_slice,
    data_shard_index,
    make_mesh,
)


def sce_cases(spec, inputs, out):
    """Loss and gradients of ``sce_loss_sharded`` for every case on every
    mesh: ``dx`` is this rank's rows of x's gradient, ``dy`` its data
    shard's share of y's (the whole table)."""
    for shape in spec["meshes"]:
        mesh = make_mesh(tuple(shape))
        tag = f"{shape[0]}x{shape[1]}"
        for i, case in enumerate(spec["sce_cases"]):
            p = case["inputs"]
            x, y = inputs[f"{p}_x"], inputs[f"{p}_y"]
            t, vm = inputs[f"{p}_t"], inputs[f"{p}_vm"]
            omega = inputs[f"{p}_omega_{tag}_{i}"][data_shard_index(mesh)]
            rows = batch_slice(mesh, x.shape[0])
            xt = torch.from_numpy(x[rows].copy()).requires_grad_(True)
            yt = torch.from_numpy(y.copy()).requires_grad_(True)
            cfg = SCEConfig(*case["cfg"], use_mix=case["mix"],
                            use_kernel=case["kernel"],
                            logit_softcap=case["cap"])
            loss = sce_loss_sharded(
                xt, yt, torch.from_numpy(t[rows].copy()), cfg=cfg,
                mesh=mesh, valid_mask=torch.from_numpy(vm[rows].copy()),
                mode=case["mode"], omega=torch.from_numpy(omega))
            dx, dy = torch.autograd.grad(loss, (xt, yt))
            out[f"sce_{tag}_{i}_loss"] = loss.detach().numpy()
            out[f"sce_{tag}_{i}_dx"] = dx.numpy()
            out[f"sce_{tag}_{i}_dy"] = dy.numpy()
            out[f"sce_{tag}_{i}_rows"] = np.array([rows.start, rows.stop])


def merge_cases(spec, inputs, out):
    """``distributed_topk_from_local`` and ``distributed_lse_from_local``
    over the model axis of a (1, world) mesh, with the payload log."""
    m = dist.get_world_size()
    mesh = make_mesh((1, m))
    axis = mesh.axis("model")
    sl = catalog_slice(mesh, inputs["topk_scores"].shape[1])
    scores = torch.from_numpy(inputs["topk_scores"][:, sl].copy())
    k = int(inputs["topk_k"])
    coll.reset_payload_log()
    for kl in (min(k, scores.shape[1]), 2):
        order = torch.sort(scores, dim=-1, descending=True,
                           stable=True).indices[:, :kl]
        vals_l = scores.gather(1, order)
        gids_l = (order + sl.start).to(torch.int32)
        vals, gids = coll.distributed_topk_from_local(vals_l, gids_l, k, axis)
        out[f"topk_kl{kl}_vals"] = vals.numpy()
        out[f"topk_kl{kl}_ids"] = gids.numpy()
    out["topk_log_total"] = np.array(coll.payload_summary()["total_bytes"])
    out["topk_log_counts"] = np.array(
        coll.payload_summary()["counts"]["all-gather"])

    logits = torch.from_numpy(inputs["lse_logits"][:, sl].copy())
    valid = torch.from_numpy(inputs["lse_valid"][:, sl].copy())
    masked = torch.where(valid, logits, -1e30)
    m_l = masked.amax(dim=-1)
    s_l = torch.where(valid, torch.exp(masked - m_l[:, None]), 0.0).sum(-1)
    out["lse"] = coll.distributed_lse_from_local(m_l, s_l, axis).numpy()


def step_case(spec, inputs, out):
    """Two training steps of the port's step on a (world, 1) mesh, each
    rank on its data shard of the global batch, its shard's Ω injected."""
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.launch import steps
    from repro_torch.models import sasrec

    world = dist.get_world_size()
    mesh = make_mesh((world, 1))
    arch = get_arch("sasrec-sce")
    cfg = arch.make_smoke_config()
    gb = inputs["step_tokens_0"].shape[0]
    step, (opt_init, _), sce_cfg = steps.make_seqrec_train_step(
        arch, cfg, ShapeSpec("train_smoke", "train", {"batch": gb}),
        mesh=mesh, sce_mode="exact")
    params = sasrec.init_params(cfg, seed=0, device="cpu")
    state = opt_init(params)
    rows = batch_slice(mesh, gb)
    for i in range(spec["step_steps"]):
        batch = {k: torch.from_numpy(inputs[f"step_{k}_{i}"][rows].copy())
                 for k in ("tokens", "targets", "valid")}
        omega = inputs[f"step_omega_{i}"][data_shard_index(mesh)]
        params, state, metrics = step(params, state, batch,
                                      omega=torch.from_numpy(omega))
        out[f"step_{i}_loss"] = metrics["loss"].numpy()
        out[f"step_{i}_grad_norm"] = metrics["grad_norm"].numpy()
        out[f"step_{i}_skipped"] = metrics["skipped"].numpy()
    out["step_n_buckets"] = np.array(sce_cfg.n_buckets)


def train_case(spec, inputs, out):
    """The trainer itself on the world: its default exact mode on the
    ``make_host_mesh(max_data=batch)`` mesh."""
    from repro_torch.launch.train import train

    res = train("sasrec-sce", steps=2, batch=spec["train_batch"],
                device="cpu", log_every=0)
    out["train_losses"] = np.array(res["losses"])


TASKS = {"sce": sce_cases, "merge": merge_cases, "step": step_case,
         "train": train_case}


def main(rank: int, world: int, root: Path) -> None:
    torch.set_num_threads(1)
    spec = json.loads((root / "spec.json").read_text())
    inputs = dict(np.load(root / "inputs.npz"))
    dist.init_process_group("gloo", init_method=f"file://{root}/rdv",
                            rank=rank, world_size=world)
    try:
        out = {}
        for task in spec["tasks"]:
            TASKS[task](spec, inputs, out)
        np.savez(root / f"out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
