"""The port's CTR models (DCN-v2, DLRM, xDeepFM), their data, steps and
trainer against the JAX package's, at the smoke configs on the CPU.

JAX parameters (``repro.models.recsys.init_*``, biases made non-zero) go
through ``recsys_params_from_jax``; both sides take the same numpy
batches. Tolerances (f32 fold order, scaled to the tensor's magnitude):
logits and probabilities within ``1e-5·max|x|`` (plus ``rtol 1e-5``);
losses and grad norms within ``1e-5`` relative; gradients within
``1e-5·max|g|`` a leaf; params after AdamW within ``1e-5·max|p|``, but
where the reference's gradient is below ``1e-5·max|g|`` (there Adam turns
f32 noise into a full ±lr step) within ``2·lr``; with int8 compression
the quantized gradient can round one step apart, so within ``2·lr`` with
at most 1 % of a leaf beyond ``1e-5·max|p|``. The clickstream batches are
bit for bit; the trainer resumes bit for bit; on a gloo world of 2 the
trainer's losses and params are one process's within the step rule.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.common import ShapeSpec as JaxShapeSpec
from repro.data import ClickDataConfig as JaxClickDataConfig
from repro.data import ClickstreamDataset as JaxClickstreamDataset
from repro.data import Cursor as JaxCursor
from repro.data import ShardedCursor as JaxShardedCursor
from repro.launch import steps as jax_steps
from repro.models import recsys as jax_recsys
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import (ClickDataConfig, ClickstreamDataset, Cursor,
                              ShardedCursor)
from repro_torch.launch import steps
from repro_torch.launch.train import to_device, train
from repro_torch.models import recsys
from repro_torch.models.convert import recsys_params_from_jax
from repro_torch.optim.optimizers import tree_leaves
from test_torch_distributed_sce import _start, _wait

ARCHS = ("dcn-v2", "dlrm-rm2", "xdeepfm")
JAX_INIT = {"dcn-v2": jax_recsys.init_dcn_v2, "dlrm-rm2": jax_recsys.init_dlrm,
            "xdeepfm": jax_recsys.init_xdeepfm}
JAX_FWD = {"dcn-v2": jax_recsys.dcn_v2_forward,
           "dlrm-rm2": jax_recsys.dlrm_forward,
           "xdeepfm": jax_recsys.xdeepfm_forward}
BATCH = 8
LR = 1e-3
B1 = 0.9


def _np_tree(tree):
    """Nested dicts and lists of tensors or arrays → the same of numpy
    copies."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return np.array(tree, copy=True)


def _close(got, want, rel=1e-5):
    """``got`` within ``rel·max|want|`` (plus ``rel`` relative) of want."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _clicks(cfg, batch=BATCH, seed=0):
    data = ClickstreamDataset(ClickDataConfig(
        vocab_sizes=cfg.vocab_sizes, batch_size=batch,
        n_dense=getattr(cfg, "n_dense", 1)))
    return data.next_batch(Cursor(seed=seed))[0]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """One arch's smoke configs on both sides and the same weights, the
    biases drawn non-zero: a numpy tree in the reference's layout (the
    port's random init, which keeps that layout; compiling the
    reference's init would cost seconds a test run), for both sides."""
    name = request.param
    jcfg = jax_get_arch(name).make_smoke_config()
    cfg = get_arch(name).make_smoke_config()
    jp = _np_tree(steps.RECSYS_INIT[name](cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(1)

    def bias(tree):
        for k, v in (tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
            if isinstance(v, (dict, list)):
                bias(v)
            elif (isinstance(k, str) and k.startswith("b")) or \
                    k in ("head_b", "bias"):
                tree[k] = rng.normal(scale=0.1, size=v.shape).astype(
                    np.float32)
    bias(jp)
    if "cross_b" in jp:
        jp["cross_b"] = [rng.normal(scale=0.1, size=b.shape).astype(
            np.float32) for b in jp["cross_b"]]
    return name, jcfg, cfg, jp, recsys_params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("hosts", [1, 2, 4])
@pytest.mark.parametrize("hot", [1, 2])
def test_clickstream_batches_bit_for_bit(hosts, hot):
    """``next_batch`` and each host's ``next_batch_sharded`` slice equal
    the reference's, values and dtypes."""
    vocab = get_arch("xdeepfm").make_smoke_config().vocab_sizes
    kw = dict(vocab_sizes=vocab, batch_size=8, hot=hot, n_dense=5)
    mine = ClickstreamDataset(ClickDataConfig(**kw))
    ref = JaxClickstreamDataset(JaxClickDataConfig(**kw))
    for step in (0, 3):
        if hosts == 1:
            got, _ = mine.next_batch(Cursor(seed=2, step=step))
            want, _ = ref.next_batch(JaxCursor(seed=2, step=step))
            pairs = [(got, want)]
        else:
            pairs = [(mine.next_batch_sharded(ShardedCursor(
                Cursor(seed=2, step=step), host_id=h, n_hosts=hosts))[0],
                ref.next_batch_sharded(JaxShardedCursor(
                    JaxCursor(seed=2, step=step), host_id=h,
                    n_hosts=hosts))[0]) for h in range(hosts)]
        for got, want in pairs:
            assert set(got) == set(want) == {"dense", "sparse_ids", "labels"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_configs_match_reference():
    for name in ARCHS:
        mine, ref = get_arch(name), jax_get_arch(name)
        assert dataclasses.asdict(mine.make_config()) == \
            dataclasses.asdict(ref.make_config())
        assert dataclasses.asdict(mine.make_smoke_config()) == \
            dataclasses.asdict(ref.make_smoke_config())
        assert mine.make_config().param_count() == \
            ref.make_config().param_count()
        assert [(s.name, s.kind, dict(s.dims)) for s in mine.shapes] == \
            [(s.name, s.kind, dict(s.dims)) for s in ref.shapes]
        assert (mine.family, mine.optimizer, mine.train_loss) == \
            (ref.family, ref.optimizer, ref.train_loss)
    rows = {n: sum(get_arch(n).make_config().vocab_sizes) for n in ARCHS}
    assert rows == {"dcn-v2": 31_548_984, "dlrm-rm2": 35_048_984,
                    "xdeepfm": 19_977_764}


def test_converter_copies_every_leaf(model):
    """The reference's init's layout (its tree and shapes, traced without
    compiling) is the port's; the converter copies such a tree leaf for
    leaf, its lists as lists."""
    name, jcfg, cfg, jp, tp = model
    ref = jax.eval_shape(lambda k: JAX_INIT[name](k, jcfg),
                         jax.random.PRNGKey(0))
    assert jax.tree.structure(ref) == jax.tree.structure(jp)
    assert [a.shape for a in jax.tree.leaves(ref)] == \
        [w.shape for w in jax.tree.leaves(jp)]
    want = jax.tree.leaves(jp)
    got = tree_leaves(tp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)
    for k in ("tables", "linear", "cin_w", "cross_w"):
        if k in jp:
            assert isinstance(tp[k], list) and len(tp[k]) == len(jp[k])
    with pytest.raises(KeyError):
        recsys_params_from_jax({**jp, "extra": jp["tables"][0]},
                               device="cpu")


def test_forward_loss_and_grads_match_jax(model):
    """Logits, the BCE loss and every parameter's gradient against
    ``jax.grad`` of the reference's forward and loss."""
    name, jcfg, cfg, jp, tp = model
    b = _clicks(cfg, batch=32, seed=3)
    jfwd = JAX_FWD[name]

    def jloss(p):
        logits = jfwd(p, jcfg, jnp.asarray(b["dense"]),
                      jnp.asarray(b["sparse_ids"]))
        return jax_recsys.bce_logits_loss(logits, jnp.asarray(b["labels"]))

    want_logits, (want_loss, want_grads) = jax.jit(lambda p: (jfwd(
        p, jcfg, b["dense"], b["sparse_ids"]),
        jax.value_and_grad(jloss)(p)))(jp)
    want_logits = np.asarray(want_logits)
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tp)]
    params = steps._unflatten(tp, leaves)
    t = to_device(b, "cpu")
    logits = steps.recsys_forward_fn(name)(params, cfg, t["dense"],
                                           t["sparse_ids"])
    _close(logits.detach().numpy(), want_logits)
    loss = recsys.bce_logits_loss(logits, t["labels"])
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    for g, w in zip(grads, jax.tree.leaves(want_grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))
    # the loss's valid mask as the reference's
    valid = np.arange(32) % 3 != 0
    got = recsys.bce_logits_loss(logits.detach(), t["labels"],
                                 torch.from_numpy(valid))
    want = jax_recsys.bce_logits_loss(jnp.asarray(want_logits),
                                      jnp.asarray(b["labels"]),
                                      jnp.asarray(valid))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_serve_and_retrieval_steps_match_jax(model):
    """The serve step's probabilities (rows in chunks of 5, so several
    run) and the retrieval step with chunk 16 over 53 candidates (four
    chunks, the last ragged): values within tolerance, positions equal
    wherever a score stands apart from its neighbours by more than it."""
    name, jcfg, cfg, jp, tp = model
    jarch, arch = jax_get_arch(name), get_arch(name)
    b = _clicks(cfg, batch=12, seed=4)
    want = np.asarray(jax.jit(jax_steps.make_recsys_serve_step(jarch, jcfg))(
        jp, b["dense"], b["sparse_ids"]))
    t = to_device(b, "cpu")
    got = steps.make_recsys_serve_step(arch, cfg, chunk=5)(
        tp, t["dense"], t["sparse_ids"])
    _close(got.numpy(), want)
    assert not got.requires_grad

    k = 10
    cand = np.random.default_rng(5).permutation(
        cfg.vocab_sizes[0])[:53].astype(np.int32)
    jret = jax.jit(jax_steps.make_recsys_retrieval_step(
        jarch, jcfg, chunk=16, top_k=k))
    wv, wi = (np.asarray(a) for a in jret(jp, b["dense"][:1],
                                          b["sparse_ids"][:1], cand))
    gv, gi = steps.make_recsys_retrieval_step(arch, cfg, chunk=16, top_k=k)(
        tp, t["dense"][:1], t["sparse_ids"][:1], torch.from_numpy(cand))
    assert gi.dtype == torch.int32 and gv.shape == (k,)
    scores = np.asarray(jax_recsys.retrieval_scores(
        JAX_FWD[name], jp, jcfg, b["dense"][:1], b["sparse_ids"][:1],
        jnp.asarray(cand), chunk=16))
    tol = 1e-5 * np.abs(scores).max()
    _close(gv.numpy(), wv)
    srt = np.sort(scores)[::-1]
    gap = np.minimum(np.abs(srt[:k] - srt[1:k + 1]),
                     np.abs(srt[:k] - np.r_[np.inf, srt[:k - 1]]))
    iso = gap > tol
    assert iso.sum() >= k // 2
    np.testing.assert_array_equal(gi.numpy()[iso], wi[iso])


def test_cin_blocks_equal_one_block():
    """xDeepFM's CIN in blocks of 3 rows (each recomputed in the backward)
    equals the CIN in one block: values and gradients, rows being
    independent and the recompute computing the same values."""
    g = torch.Generator().manual_seed(8)
    x0 = torch.randn(10, 4, 3, generator=g)
    ws = [torch.randn(5, 4, 4, generator=g), torch.randn(6, 5, 4, generator=g)]
    out = {}
    for rows in (3, 64):
        leaves = [t.clone().requires_grad_(True) for t in [x0] + ws]
        y = recsys.cin(leaves[1:], leaves[0], rows=rows)
        out[rows] = (y.detach(), torch.autograd.grad(
            (y * torch.arange(y.numel()).reshape(y.shape)).sum(), leaves))
    _close(out[3][0].numpy(), out[64][0].numpy())
    for a, b in zip(out[3][1], out[64][1]):
        _close(a.numpy(), b.numpy())


def test_embedding_bag_matches_jax():
    """Bags of 3 ids, weighted and not, summed and averaged."""
    rng = np.random.default_rng(6)
    table = rng.normal(size=(20, 4)).astype(np.float32)
    ids = rng.integers(0, 20, size=(5, 3)).astype(np.int32)
    w = rng.random((5, 3)).astype(np.float32)
    for weights in (None, w):
        for mode in ("sum", "mean"):
            want = jax_recsys.embedding_bag(
                jnp.asarray(table), jnp.asarray(ids),
                None if weights is None else jnp.asarray(weights), mode)
            got = recsys.embedding_bag(
                torch.from_numpy(table), torch.from_numpy(ids),
                None if weights is None else torch.from_numpy(weights), mode)
            _close(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        recsys.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                             mode="max")


@pytest.mark.parametrize("compression", [None, "int8"])
def test_train_step_matches_reference(model, compression):
    """One guarded AdamW step of ``make_recsys_train_step`` against the
    reference's jitted step from the same weights on the same batch."""
    name, jcfg, cfg, jp, tp = model
    jarch, arch = jax_get_arch(name), get_arch(name)
    b = _clicks(cfg, seed=7)
    jstep, (jinit, _) = jax_steps.make_recsys_train_step(
        jarch, jcfg, None, JaxShapeSpec("train_batch", "train",
                                        {"batch": BATCH}),
        grad_compression=compression)
    jp2, js, jm = jax.jit(lambda p, bt, k: jstep(p, jinit(p), bt, k))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, b),
        jax.random.PRNGKey(0))
    # the gradient the update saw: the first step's m is (1 − b1)·g
    m = js.inner["m"] if compression is None else js.inner["base"]["m"]
    grads = jax.tree.map(lambda a: a / (1 - B1), m)
    step, (init, _) = steps.make_recsys_train_step(
        arch, cfg, ShapeSpec("train_batch", "train", {"batch": BATCH}),
        grad_compression=compression)
    params = recsys_params_from_jax(jp, device="cpu")
    marks = []
    tp2, state, tm = step(params, init(params), to_device(b, "cpu"),
                          mark=marks.append)
    assert marks == ["forward", "backward", "optimizer"]
    assert not bool(tm["skipped"]) and not bool(jm["skipped"])
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert int(state.step) == 1
    for got, want, g in zip(tree_leaves(tp2), jax.tree.leaves(jp2),
                            jax.tree.leaves(grads)):
        got, want, g = got.numpy(), np.asarray(want), np.abs(np.asarray(g))
        diff = np.abs(got - want)
        assert (diff <= 2 * LR).all()
        loose = diff > 1e-5 * np.abs(want).max()
        if compression is None:
            assert not loose[g >= 1e-5 * g.max()].any()
        else:
            assert loose.mean() <= 0.01


def _final_params(ckpt_dir):
    mgr = CheckpointManager(str(ckpt_dir))
    return [np.asarray(a) for a in tree_leaves(
        mgr.restore(mgr.latest_step(), device="cpu")["params"])]


def test_trainer_resumes_bit_for_bit(tmp_path):
    """``train("dcn-v2")`` for 4 steps against 2 steps, a checkpoint and a
    resumed run to 4: the same losses and the same final params and
    AdamW state bit for bit. With ``eval_every`` it warns and skips."""
    kw = dict(batch=BATCH, device="cpu", log_every=0, ckpt_every=2)
    full = train("dcn-v2", steps=4, ckpt_dir=str(tmp_path / "a"),
                 eval_every=2, **kw)
    part = train("dcn-v2", steps=2, ckpt_dir=str(tmp_path / "b"), **kw)
    rest = train("dcn-v2", steps=4, ckpt_dir=str(tmp_path / "b"), **kw)
    assert "eval" not in full and full["skipped_steps"] == 0
    assert all(np.isfinite(full["losses"]))
    assert part["losses"] + rest["losses"] == full["losses"]
    for a, b in zip(_final_params(tmp_path / "a"),
                    _final_params(tmp_path / "b")):
        np.testing.assert_array_equal(a, b)
    mgr = CheckpointManager(str(tmp_path / "b"))
    tree = mgr.restore(mgr.latest_step(), device="cpu")
    assert isinstance(tree["params"]["tables"], list)
    assert int(tree["step"]) == 3


def test_trainer_n_hosts_and_int8_run():
    """``n_hosts`` draws the same global batches (the same losses), and
    the int8 run trains on the compressed gradients."""
    kw = dict(steps=2, batch=BATCH, device="cpu", log_every=0)
    one = train("xdeepfm", **kw)
    four = train("xdeepfm", n_hosts=4, **kw)
    assert one["losses"] == four["losses"]
    comp = train("dlrm-rm2", grad_compression="int8", **kw)
    assert all(np.isfinite(comp["losses"])) and comp["skipped_steps"] == 0


def test_trainer_on_a_gloo_world_of_two_is_one_process(tmp_path):
    """``train("dcn-v2")`` on two gloo processes (a (2, 1) mesh: each rank
    steps its rows, its loss its share of the global mean, the gradients
    summed over data) against one process's run of the same global
    batches: losses and grad norms within ``1e-5`` relative, the saved
    params within the step rule."""
    spec = {"tasks": ["recsys"], "recsys_ckpt": str(tmp_path / "two")}
    launch = _start(tmp_path / "w", 2, spec, {"none": np.zeros(1)})
    one = train("dcn-v2", steps=2, batch=BATCH, device="cpu", log_every=0,
                ckpt_dir=str(tmp_path / "one"), ckpt_every=2,
                metrics_file=str(tmp_path / "one.jsonl"))
    (outs,) = _wait([launch])
    for out in outs:
        np.testing.assert_allclose(out["recsys_losses"], one["losses"],
                                   rtol=1e-5)
    norms = [json.loads(line)["grad_norm"] for line in
             (tmp_path / "one.jsonl").read_text().splitlines()]
    for out in outs:
        np.testing.assert_allclose(out["recsys_grad_norms"], norms,
                                   rtol=1e-5)
    for a, b in zip(_final_params(tmp_path / "two"),
                    _final_params(tmp_path / "one")):
        assert (np.abs(a - b) <= 2 * 2 * LR).all()
        assert (np.abs(a - b) > 1e-5 * np.abs(b).max()).mean() <= 0.01
