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
import dataclasses
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


def unflatten(inputs, prefix):
    """The nested dict of tensors stored under ``prefix/a/b`` keys."""
    tree = {}
    for key, v in inputs.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        d = tree
        for name in path:
            d = d.setdefault(name, {})
        d[leaf] = torch.from_numpy(np.array(v))
    return tree


def _meshes(spec):
    for shape in spec["meshes"]:
        yield f"{shape[0]}x{shape[1]}", make_mesh(tuple(shape))


def infer_cases(spec, inputs, out):
    """The sharded evaluation, the serve steps, the server,
    ``distributed_topk`` and ``all_to_all_bucket_shuffle`` on every mesh.
    Every rank passes the same global inputs."""
    from repro_torch.configs import get_arch
    from repro_torch.eval import evaluate_streaming, evaluate_streaming_lm
    from repro_torch.eval import harness
    from repro_torch.launch import steps
    from repro_torch.launch.serve import RetrievalServer

    t = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()
         if "/" not in k}
    sas = get_arch("sasrec-sce").make_smoke_config()
    b4r = get_arch("bert4rec").make_smoke_config()
    lm = get_arch("gemma2-2b").make_smoke_config()
    lm = dataclasses.replace(lm, vocab=int(inputs["lm_vocab"]))
    sas_p, b4r_p, lm_p = (unflatten(inputs, n) for n in ("sas", "b4r", "lm"))
    for tag, mesh in _meshes(spec):
        for name, k, lse in (("sweep", 5, False), ("sweep_lm", 1, True)):
            outs = harness._rank_topk_sharded(
                t[f"{name}_x"], t[f"{name}_y"], t[f"{name}_t"], k,
                mesh=mesh, block_c=16, c_lo=1, c_hi=int(inputs[f"{name}_hi"]),
                with_lse=lse, logit_softcap=30.0 if lse else None)
            for what, o in zip(("vals", "ids", "gt", "eq", "tgt", "lse"),
                               outs):
                out[f"{tag}_{name}_{what}"] = o.numpy()
        lm_batch = {k: inputs[f"lm_eval_{k}"]
                    for k in ("tokens", "targets", "valid")}
        for name, got in (
                ("eval", evaluate_streaming(
                    sas_p, sas, {"tokens": inputs["eval_tokens"]},
                    mesh=mesh, block_c=128)),
                ("eval_lm", evaluate_streaming_lm(lm_p, lm, lm_batch,
                                                  mesh=mesh))):
            out[f"{tag}_{name}_keys"] = np.array(sorted(got))
            out[f"{tag}_{name}_vals"] = np.array([got[k] for k in sorted(got)])
        hist = t["hist"]
        for name, make, args in (
                ("mips", steps.make_seqrec_mips_serve_step, (hist,)),
                ("serve", steps.make_seqrec_serve_step, (hist,)),
                ("retrieval", steps.make_seqrec_retrieval_step,
                 (hist[:2], t["cand"])),
                ("retrieval_ties", steps.make_seqrec_retrieval_step,
                 (hist[:1], t["cand_ties"]))):
            vals, ids = make(b4r, top_k=int(inputs[f"{name}_k"]),
                             mesh=mesh)(b4r_p, *args)
            out[f"{tag}_{name}_vals"] = vals.numpy()
            out[f"{tag}_{name}_ids"] = ids.numpy()
        server = RetrievalServer("bert4rec", params=b4r_p, buckets=(4, 8),
                                 top_k=7, device="cpu", mesh=mesh)
        vals, ids = server.score(inputs["hist"][:5])
        out[f"{tag}_server_vals"], out[f"{tag}_server_ids"] = vals, ids
        out[f"{tag}_server_ready"] = np.array(server.ready)
        server.close()

        axis = mesh.axis("model")
        sl = catalog_slice(mesh, inputs["topk_scores"].shape[1])
        vals, gids, src = coll.distributed_topk(
            t["topk_scores"][:, sl], int(inputs["topk_k"]), axis)
        out[f"{tag}_dtopk_vals"] = vals.numpy()
        out[f"{tag}_dtopk_ids"] = gids.numpy()
        out[f"{tag}_dtopk_src"] = src.numpy()

        coll.reset_payload_log()
        x = (t["shuffle_x"] + 100.0 * dist.get_rank()).requires_grad_(True)
        shuffled = coll.all_to_all_bucket_shuffle(x, axis)
        w = t["shuffle_w"][:axis.size, None, None]
        (g,) = torch.autograd.grad((shuffled * w).sum(), x)
        out[f"{tag}_shuffle_out"] = shuffled.detach().numpy()
        out[f"{tag}_shuffle_grad"] = g.numpy()
        out[f"{tag}_shuffle_log"] = np.array(json.dumps(coll.payload_log()))
        out[f"{tag}_coords"] = np.array([mesh.coords["data"],
                                         mesh.coords["model"]])


def dp_steps(spec, out, mesh=None, inputs=None):
    """``spec["dp_cases"]``' data-parallel steps, each rank on its block
    of every global microbatch (``batch_rows``); with no ``mesh`` (the
    tests' own process) one process's global step. A case with ``jax``
    starts from the JAX package's weights in ``inputs`` (``jaxp/…``),
    the others from the port's own."""
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.dist.sharding import batch_rows
    from repro_torch.launch import steps
    from repro_torch.models import bert4rec, sasrec, transformer

    for case in spec["dp_cases"]:
        arch = get_arch(case["arch"])
        arch = dataclasses.replace(arch, train_loss=case["loss"],
                                   microbatches={case["shape"]: case["micro"]})
        cfg = arch.make_smoke_config()
        gb = case["batch"]
        if arch.family == "lm":
            shape = ShapeSpec(case["shape"], "train",
                              {"global_batch": gb, "seq_len": case["seq"]})
            make = steps.make_lm_train_step
            params = transformer.init_params(cfg, seed=0, device="cpu")
            data = SequenceDataset(SeqDataConfig(
                n_items=cfg.vocab, seq_len=case["seq"], batch_size=gb,
                min_len_frac=1.0))
        else:
            shape = ShapeSpec(case["shape"], "train", {"batch": gb})
            make = steps.make_seqrec_train_step
            init = sasrec.init_params if cfg.causal else bert4rec.init_params
            params = (unflatten(inputs, "jaxp") if case.get("jax")
                      else init(cfg, seed=0, device="cpu"))
            data = SequenceDataset(SeqDataConfig(
                n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=gb))
        step, (opt_init, _), _ = make(arch, cfg, shape, mesh=mesh,
                                      sce_mode=case["mode"])
        n_micro = steps.n_microbatches(arch, shape, mesh)
        rows = (batch_rows(mesh, gb, n_micro) if mesh is not None
                else slice(None))
        keys = ("tokens", "targets", "valid") if getattr(
            cfg, "causal", True) else ("tokens",)
        state, gen, cur = opt_init(params), \
            torch.Generator().manual_seed(0), Cursor(seed=0)
        losses, norms = [], []
        for _ in range(2):
            batch, cur = data.next_batch(cur)
            batch = {k: torch.from_numpy(np.ascontiguousarray(batch[k][rows]))
                     for k in keys}
            params, state, m = step(params, state, batch, generator=gen)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        tag = case["name"]
        out[f"dp_{tag}_losses"] = np.array(losses)
        out[f"dp_{tag}_grad_norms"] = np.array(norms)
        out[f"dp_{tag}_n_micro"] = np.array(n_micro)
        for k, v in flatten_tree(params, f"dp_{tag}_p").items():
            out[k] = v


def flatten_tree(tree, prefix):
    """``tree``'s leaves under ``prefix/a/b`` keys, as numpy arrays (the
    inverse of :func:`unflatten`)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v.detach().numpy()
    return out


def dtrain_cases(spec, inputs, out):
    """The data-parallel steps on a (world, 1) mesh, and the trainer's
    checkpoints over the world: saved here and restored on one process,
    and restored here from one process's."""
    from repro_torch.launch.train import train

    dp_steps(spec, out, make_mesh((dist.get_world_size(), 1)), inputs)
    kw = dict(batch=4, device="cpu", log_every=0, train_loss="ce_fused_linear",
              grad_compression="int8", ckpt_every=2)
    saved = train("sasrec-sce", steps=2, n_hosts=2,
                  ckpt_dir=spec["ckpt_here"], **kw)
    resumed = train("sasrec-sce", steps=4, ckpt_dir=spec["ckpt_there"], **kw)
    out["ckpt_saved_losses"] = np.array(saved["losses"])
    out["ckpt_resumed_losses"] = np.array(resumed["losses"])
    # the wall-clock policy on a clock that ticks once a reading: rank 0's
    # saves reset only its own, and its decision is every rank's
    import functools
    import itertools

    from repro_torch.launch import train as train_mod

    ticks = itertools.count()
    real = train_mod.CheckpointManager
    train_mod.CheckpointManager = functools.partial(
        real, _clock=lambda: float(next(ticks)))
    try:
        train("sasrec-sce", steps=spec["interval_steps"], batch=4,
              device="cpu", log_every=0, ckpt_dir=spec["ckpt_interval"],
              ckpt_interval_s=spec["interval_s"], keep_n=100)
    finally:
        train_mod.CheckpointManager = real


def recsys_case(spec, inputs, out):
    """``train("dcn-v2")`` on the world's (world, 1) mesh: its losses and
    grad norms (from its metrics file); rank 0 saves the last step."""
    from repro_torch.launch.train import train

    metrics = Path(f"{spec['recsys_ckpt']}.{dist.get_rank()}.jsonl")
    res = train("dcn-v2", steps=2, batch=8, device="cpu", log_every=0,
                ckpt_dir=spec["recsys_ckpt"], ckpt_every=2,
                metrics_file=str(metrics))
    out["recsys_losses"] = np.array(res["losses"])
    out["recsys_grad_norms"] = np.array([
        json.loads(line)["grad_norm"]
        for line in metrics.read_text().splitlines()])


TASKS = {"sce": sce_cases, "merge": merge_cases, "step": step_case,
         "train": train_case, "infer": infer_cases, "dtrain": dtrain_cases,
         "recsys": recsys_case}


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
