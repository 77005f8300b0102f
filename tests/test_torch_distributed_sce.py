"""The port's distributed SCE against the JAX package's.

``repro_torch.core.distributed_sce.sce_loss_sharded`` runs on (1, 1) in
this process and on (1, 2), (2, 1), (2, 2) and (1, 4) meshes of ``gloo``
processes (``tests/_dist_workers.py``, which imports no JAX; rendezvous
through a file, a timeout on every process). Its loss and the gradients
of ``x`` and ``y`` are held against ``jax.value_and_grad`` of the JAX
package's single-device oracle ``sce_loss_sharded_ref`` on the global
arrays, with the oracle's own per-shard draws
``jax.random.normal(fold_in(key, i), …)`` injected into the port. On
(1, 1) the loss also goes against JAX's ``sce_loss_sharded`` itself
(``use_kernel=False``: with the kernel flag it fails inside ``shard_map``
on jax 0.9, ROADMAP queue 3). The (1, 2) and (2, 2) meshes put two model
ranks on each data shard: a gradient rule that counted the replicated
terms (the merged loss, the positive logit) once per model rank would
double them there. Cases cover exact and union modes, Mix on and off,
softcap 30, the CPU kernel path (``use_kernel``: the plain
``mips_topk`` and ``sce_gather_plse`` versions) and ``b_y`` above both
``C/m`` and ``C``.

The merge collectives run on 2 and 4 ranks: the exact top-k's tie order
against ``lax.top_k`` on integer-valued ties across shards, and the LSE
merge with a shard that owns no valid column. Two data-parallel steps of
the train step on a (2, 1) mesh go against the port's single-process
computation of the same global loss, and the trainer runs on 2 ranks.

Tolerances as in ``tests/test_distributed.py``: loss ``rtol 1e-5``;
gradients ``rtol 1e-4``, ``atol 1e-6·max|g|``.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed_sce as jdsce
from repro.core.sce import SCEConfig as JaxSCEConfig
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro_torch.core.distributed_sce import sce_loss_sharded, sce_loss_sharded_ref
from repro_torch.core.sce import SCEConfig
from repro_torch.dist.sharding import make_mesh

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

N, C, D = 96, 64, 16
# (inputs, mode, Mix, use_kernel, softcap, (n_b, b_x, b_y)); n_b = 5
# rounds up to the model axis, 8 divides every axis size here
CASES = [
    ("a", "exact", True, False, None, (8, 16, 24)),  # b_y > C/4
    ("cap", "exact", True, True, 30.0, (8, 16, 24)),
    ("a", "exact", False, False, None, (5, 12, 80)),  # b_y > C
    ("a", "union", True, True, None, (8, 16, 24)),
    ("cap", "union", False, False, 30.0, (8, 16, 24)),
]
WORLDS = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}
MESHES = [(1, 1)] + WORLDS[2] + WORLDS[4]


def _problems():
    rng = np.random.default_rng(7)
    out = {}
    x = rng.standard_normal((N, D)).astype(np.float32)
    for name, scale in (("a", 1.0), ("cap", 4.0)):
        out[f"{name}_x"] = (x * scale).astype(np.float32)
        out[f"{name}_y"] = rng.standard_normal((C, D)).astype(np.float32)
        out[f"{name}_t"] = rng.integers(0, C, N).astype(np.int32)
        out[f"{name}_vm"] = rng.random(N) > 0.2
    return out


def _key(i):
    return jax.random.PRNGKey(10 + i)


def _n_b(n_b, m):
    return -(-n_b // m) * m


def _omegas(shape, i):
    """The reference's per-shard draws: ``fold_in(key, shard)``."""
    dp, m = shape
    p, _, mix, _, _, (n_b, _, _) = CASES[i]
    n_b = _n_b(n_b, m)
    draw = (n_b, N // dp) if mix else (n_b, D)
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(_key(i), s), draw, jnp.float32))
        for s in range(dp)])


def _start(tmp, world, spec, inputs):
    """Start ``world`` ranks of ``_dist_workers.py`` in ``tmp``."""
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "spec.json").write_text(json.dumps(spec))
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    return tmp, [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_dist_workers.py"), str(r),
         str(world), str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait(launches):
    """Wait for every rank (each within ``TIMEOUT_S``, killed past it);
    → per launch, each rank's output."""
    logs = []
    try:
        for _, procs in launches:
            logs.append([p.communicate(timeout=TIMEOUT_S)[0] for p in procs])
    finally:
        for _, procs in launches:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    outs = []
    for (tmp, procs), plogs in zip(launches, logs):
        for r, (p, log) in enumerate(zip(procs, plogs)):
            assert p.returncode == 0, f"rank {r} exit {p.returncode}:\n{log}"
        outs.append([dict(np.load(tmp / f"out{r}.npz"))
                     for r in range(len(procs))])
    return outs


def _merge_inputs(world):
    rng = np.random.default_rng(world)
    c = 8 * world
    lse_valid = rng.random((5, c)) > 0.3
    lse_valid[:, :c // world] = False  # shard 0 owns no valid column
    return {
        # integer-valued: ties across shards everywhere
        "topk_scores": rng.integers(-2, 3, (6, c)).astype(np.float32),
        "topk_k": np.array(5),
        "lse_logits": rng.standard_normal((5, c)).astype(np.float32) * 3,
        "lse_valid": lse_valid,
    }


STEP_BATCH, STEP_STEPS = 4, 2


def _step_inputs():
    from repro_torch.configs import get_arch
    from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
    from repro_torch.launch.steps import build_sce_config

    cfg = get_arch("sasrec-sce").make_smoke_config()
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=STEP_BATCH))
    n_b = build_sce_config(STEP_BATCH // 2 * cfg.max_len, cfg.n_items,
                           bucket_size_y=256).n_buckets
    rng = np.random.default_rng(3)
    out, cur = {}, Cursor(seed=0)
    for i in range(STEP_STEPS):
        b, cur = data.next_batch(cur)
        for k, v in b.items():
            out[f"step_{k}_{i}"] = v
        out[f"step_omega_{i}"] = rng.standard_normal(
            (2, n_b, STEP_BATCH // 2 * cfg.max_len)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Every rank's results: the SCE cases on every mesh, and per world
    the merge collectives; on 2 ranks also the steps and the trainer."""
    probs = _problems()
    out, launches = {}, []
    for world, meshes in WORLDS.items():
        inputs = dict(probs)
        for shape in meshes:
            for i in range(len(CASES)):
                inputs[f"{CASES[i][0]}_omega_{shape[0]}x{shape[1]}_{i}"] = \
                    _omegas(shape, i)
        inputs.update(_merge_inputs(world))
        tasks = ["sce", "merge"]
        if world == 2:
            inputs.update(_step_inputs())
            tasks += ["step", "train"]
        spec = {"tasks": tasks, "meshes": meshes, "step_steps": STEP_STEPS,
                "train_batch": STEP_BATCH,
                "sce_cases": [{"inputs": p, "mode": mode, "mix": mix,
                               "kernel": kern, "cap": cap, "cfg": list(cfg)}
                              for p, mode, mix, kern, cap, cfg in CASES]}
        launches.append(_start(tmp_path_factory.mktemp(f"world{world}"),
                               world, spec, inputs))
        out[f"inputs{world}"] = inputs
    for world, ranks in zip(WORLDS, _wait(launches)):
        out[world] = ranks
    return out


def _oracle(i, shape):
    """Loss and gradients of the JAX oracle on the global arrays. In exact
    mode the model axis only rounds ``n_b``, so meshes that round alike
    share one oracle."""
    p, mode, mix, _, cap, cfg = CASES[i]
    dp, m = shape
    if mode == "exact" and cfg[0] % m == 0:
        m = 1
    return _oracle_at(i, dp, m)


@functools.lru_cache(maxsize=None)
def _oracle_at(i, dp, m):
    p, mode, mix, _, cap, cfg = CASES[i]
    probs = _problems()
    x, y, t, vm = (probs[f"{p}_{k}"] for k in ("x", "y", "t", "vm"))
    jcfg = JaxSCEConfig(*cfg, use_mix=mix, logit_softcap=cap)

    def f(x, y):
        return jdsce.sce_loss_sharded_ref(
            x, y, jnp.asarray(t), key=_key(i), cfg=jcfg, dp_size=dp,
            valid_mask=jnp.asarray(vm), mode=mode, tp_size=m)

    loss, (dx, dy) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(y))
    return float(loss), np.asarray(dx), np.asarray(dy)


def _local(i, shape):
    """(1, 1) in this process, no process group."""
    p, mode, mix, kern, cap, cfg = CASES[i]
    probs = _problems()
    xt = torch.from_numpy(probs[f"{p}_x"]).requires_grad_(True)
    yt = torch.from_numpy(probs[f"{p}_y"]).requires_grad_(True)
    loss = sce_loss_sharded(
        xt, yt, torch.from_numpy(probs[f"{p}_t"]),
        cfg=SCEConfig(*cfg, use_mix=mix, use_kernel=kern, logit_softcap=cap),
        mesh=make_mesh((1, 1)), valid_mask=torch.from_numpy(probs[f"{p}_vm"]),
        mode=mode, omega=torch.from_numpy(_omegas(shape, i)[0]))
    dx, dy = torch.autograd.grad(loss, (xt, yt))
    return float(loss.detach()), dx.numpy(), dy.numpy()


def _assemble(outputs, i, shape):
    """The global loss and gradients from the ranks: x's rows from each
    data shard, y's gradient summed over the data shards; every model
    rank of a shard must hold the same values."""
    if shape == (1, 1):
        return _local(i, shape)
    dp, m = shape
    ranks = outputs[dp * m]
    tag = f"{dp}x{m}_{i}"
    losses = [float(r[f"sce_{tag}_loss"]) for r in ranks[:dp * m]]
    assert max(losses) == min(losses), losses
    dx = np.zeros((N, D), np.float32)
    dy = np.zeros((C, D), np.float32)
    for s in range(dp):
        shard = ranks[s * m:(s + 1) * m]
        for r in shard[1:]:
            np.testing.assert_array_equal(r[f"sce_{tag}_dx"],
                                          shard[0][f"sce_{tag}_dx"])
            np.testing.assert_array_equal(r[f"sce_{tag}_dy"],
                                          shard[0][f"sce_{tag}_dy"])
        lo, hi = shard[0][f"sce_{tag}_rows"]
        dx[lo:hi] = shard[0][f"sce_{tag}_dx"]
        dy += shard[0][f"sce_{tag}_dy"]
    return losses[0], dx, dy


def _close_grad(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=lambda i: "_".join(
                             str(v) for v in CASES[i][1:5]) + f"_{i}")
def test_sce_loss_sharded_matches_oracle(outputs, i, shape):
    loss, dx, dy = _assemble(outputs, i, shape)
    want_loss, want_dx, want_dy = _oracle(i, shape)
    assert np.isfinite(loss) and np.isfinite(dx).all() and np.isfinite(dy).all()
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _close_grad(dx, want_dx)
    _close_grad(dy, want_dy)


@pytest.mark.parametrize("mode", ["exact", "union"])
def test_one_by_one_mesh_matches_jax_sce_loss_sharded(mode):
    """On (1, 1) the port equals JAX's ``sce_loss_sharded`` itself (its
    plain selection, ``use_kernel=False``)."""
    probs = _problems()
    x, y, t, vm = (probs[f"a_{k}"] for k in ("x", "y", "t", "vm"))
    cfg = (8, 16, 32)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda x, y: jdsce.sce_loss_sharded(
        x, y, jnp.asarray(t), key=key, cfg=JaxSCEConfig(*cfg),
        mesh=jax_host_mesh(), valid_mask=jnp.asarray(vm), mode=mode))(
        jnp.asarray(x), jnp.asarray(y))
    omega = np.array(jax.random.normal(jax.random.fold_in(key, 0),
                                       (cfg[0], N), jnp.float32))
    for kern in (False, True):
        got = sce_loss_sharded(
            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t),
            cfg=SCEConfig(*cfg, use_kernel=kern), mesh=make_mesh((1, 1)),
            valid_mask=torch.from_numpy(vm), mode=mode,
            omega=torch.from_numpy(omega))
        assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_port_oracle_matches_jax_oracle_with_the_generator_draw():
    """The port's own oracle on the draw ``sce_loss_sharded`` takes from a
    generator: the same loss from the same generator state."""
    probs = _problems()
    args = [torch.from_numpy(probs[f"a_{k}"]) for k in ("x", "y", "t")]
    cfg = SCEConfig(6, 16, 24)
    got = sce_loss_sharded(*args, cfg=cfg, mesh=make_mesh((1, 1)),
                           valid_mask=torch.from_numpy(probs["a_vm"]),
                           generator=torch.Generator().manual_seed(1))
    want = sce_loss_sharded_ref(*args, cfg=cfg, dp_size=1,
                                valid_mask=torch.from_numpy(probs["a_vm"]),
                                generator=torch.Generator().manual_seed(1))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("kl", ["full", 2])
def test_distributed_topk_tie_order_matches_lax_top_k(outputs, world, kl):
    """Integer-valued scores tie across shards: the merged ids and values
    equal ``lax.top_k`` over the whole row (lower id first), on every
    rank; with 2 local candidates a shard, the top-k of their union."""
    inputs = _merge_inputs(world)
    scores, k = inputs["topk_scores"], int(inputs["topk_k"])
    c_l = scores.shape[1] // world
    if kl == "full":
        kl = min(k, c_l)
        want_v, want_i = jax.lax.top_k(jnp.asarray(scores), k)
    else:  # each shard's top-2, in shard order, then lax.top_k
        parts_v, parts_i = [], []
        for s in range(world):
            v, i = jax.lax.top_k(jnp.asarray(scores[:, s * c_l:(s + 1) * c_l]),
                                 kl)
            parts_v.append(v)
            parts_i.append(i + s * c_l)
        want_v, sel = jax.lax.top_k(jnp.concatenate(parts_v, -1),
                                    min(k, world * kl))
        want_i = jnp.take_along_axis(jnp.concatenate(parts_i, -1), sel, -1)
    for r in outputs[world]:
        np.testing.assert_array_equal(r[f"topk_kl{kl}_ids"], np.asarray(want_i))
        np.testing.assert_array_equal(r[f"topk_kl{kl}_vals"],
                                      np.asarray(want_v))


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_distributed_topk_payload_log(outputs, world):
    """Two all-gathers of (m, n, k_local) per merge, at the ring model's
    S·(m−1)/m wire bytes, as the reference records them."""
    n, k = 6, 5
    c_l = 8
    want = sum(2 * world * n * kl * 4 * (world - 1) / world
               for kl in (min(k, c_l), 2))
    for r in outputs[world]:
        assert int(r["topk_log_counts"]) == 4
        assert float(r["topk_log_total"]) == pytest.approx(want)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_distributed_lse_merge_with_an_empty_shard(outputs, world):
    """Shard 0 owns no valid column (m_l = NEG_INF, s_l = 0): it folds in
    as an exact zero, and the merge equals JAX's logsumexp over the
    valid columns."""
    inputs = _merge_inputs(world)
    want = jax.nn.logsumexp(
        jnp.where(jnp.asarray(inputs["lse_valid"]),
                  jnp.asarray(inputs["lse_logits"]), -jnp.inf), axis=-1)
    for r in outputs[world]:
        np.testing.assert_allclose(r["lse"], np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_data_parallel_step_matches_single_process_global_loss(outputs):
    """Two steps on a (2, 1) mesh, each rank on half the batch: the loss
    and the grad norm equal one process computing the same global loss
    (the port's oracle over both shards with their draws) and stepping
    AdamW on its gradient."""
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.launch import steps
    from repro_torch.models import sasrec
    from repro_torch.optim.optimizers import tree_leaves

    ranks = outputs[2]
    inputs = outputs["inputs2"]
    arch = get_arch("sasrec-sce")
    cfg = arch.make_smoke_config()
    _, (opt_init, opt_update), _ = steps.make_seqrec_train_step(
        arch, cfg, ShapeSpec("train_smoke", "train", {"batch": STEP_BATCH}))
    sce_cfg = steps.build_sce_config(STEP_BATCH // 2 * cfg.max_len,
                                     cfg.n_items, bucket_size_y=256)
    assert int(ranks[0]["step_n_buckets"]) == sce_cfg.n_buckets
    params = sasrec.init_params(cfg, seed=0, device="cpu")
    state = opt_init(params)
    for i in range(STEP_STEPS):
        flat = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        leaves = steps._unflatten(params, flat)
        hidden = sasrec.forward(leaves, cfg, torch.from_numpy(
            inputs[f"step_tokens_{i}"]))
        loss = sce_loss_sharded_ref(
            hidden.reshape(-1, hidden.shape[-1]),
            sasrec.loss_catalog(leaves, cfg),
            torch.from_numpy(inputs[f"step_targets_{i}"]).reshape(-1),
            cfg=sce_cfg, dp_size=2, mode="exact",
            valid_mask=torch.from_numpy(inputs[f"step_valid_{i}"]).reshape(-1),
            omegas=torch.from_numpy(inputs[f"step_omega_{i}"]))
        grads = steps._unflatten(params, list(torch.autograd.grad(loss, flat)))
        params, state, m = steps._apply_update_guarded(
            opt_update, loss.detach(), grads, params, state)
        for r in ranks:
            assert not bool(r[f"step_{i}_skipped"])
            assert float(r[f"step_{i}_loss"]) == pytest.approx(
                float(m["loss"]), rel=1e-5)
            assert float(r[f"step_{i}_grad_norm"]) == pytest.approx(
                float(m["grad_norm"]), rel=1e-5)


def test_trainer_runs_on_two_ranks(outputs):
    """``train()`` on a world of 2: a (2, 1) mesh, exact mode; both ranks
    see the same finite global loss at every step."""
    a, b = (r["train_losses"] for r in outputs[2])
    assert a.shape == (2,) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
