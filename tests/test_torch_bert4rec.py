"""The port's BERT4Rec against the JAX package's, at the smoke config (500
items, L 32, d 32, 2 layers).

JAX parameters (``repro.models.bert4rec.init_params``) go through
``sasrec_params_from_jax``, [MASK] row included; every random draw is
made once and injected into both sides: the cloze mask's uniform draw
(``jax.random.uniform`` of the reference's ``k_mask``) and SCE's Mix Ω
(``jax.random.normal`` of its ``k_loss``), each split from the step's key
as the reference splits it (``split(key, 3)``, per microbatch
``fold_in(key, i)`` first).

Tolerances, those of ``test_torch_sasrec.py`` / ``test_torch_train.py``:
hidden states within ``1e-5·max|h|``; losses and grad norms within
``1e-5`` relative; params within ``1e-5·max|p|`` per tensor, elements
whose reference gradient is below ``1e-5·max|g|`` (where Adam turns f32
fold-order noise into a full ±lr step) within ``2·lr`` a step taken;
cloze masks exact; evaluation metrics equal but for the rows whose rank
a dense f64 band leaves open.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.common import ShapeSpec as JaxShapeSpec
from repro.eval import harness as jax_harness
from repro.kernels import guard
from repro.launch import steps as jax_steps
from repro.models import bert4rec as jax_b4r
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.data import Cursor, SeqDataConfig, SequenceDataset
from repro_torch.eval import (bert4rec_score_fn, evaluate_streaming,
                              ranks_from_counts, streaming_eval_scores)
from repro_torch.eval import harness
from repro_torch.launch import steps, train
from repro_torch.models import bert4rec, sasrec
from repro_torch.models.convert import sasrec_params_from_jax
from repro_torch.optim.optimizers import tree_leaves, tree_map
from _rank_band import f64_band

ARCH = "bert4rec"
BATCH = 2
LR = 1e-3
B1 = 0.9
KS = (1, 5, 10)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def model():
    """Both packages' smoke configs and the same random weights, with
    non-trivial norms and biases."""
    jcfg = jax_get_arch(ARCH).make_smoke_config()
    cfg = get_arch(ARCH).make_smoke_config()
    jp = _np_tree(jax_b4r.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    for name in ("b1", "b2", "ln1_b", "ln2_b"):
        jp["layers"][name] = rng.normal(
            scale=0.1, size=jp["layers"][name].shape).astype(np.float32)
    return jcfg, cfg, jp, sasrec_params_from_jax(jp, device="cpu")


def _tokens(cfg, b=5, seed=0):
    """Front-padded histories, some positions already [MASK]."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.n_items, size=(b, cfg.max_len)).astype(np.int32)
    tok[rng.random(tok.shape) < 0.2] = cfg.n_items  # [MASK]
    lengths = rng.integers(1, cfg.max_len + 1, size=b)
    lengths[0] = cfg.max_len
    pos = np.arange(cfg.max_len)[None, :]
    return np.where(pos >= cfg.max_len - lengths[:, None], tok, 0).astype(
        np.int32)


def test_configs_match_reference():
    jarch, arch = jax_get_arch(ARCH), get_arch(ARCH)
    for make in ("make_config", "make_smoke_config"):
        jc, c = getattr(jarch, make)(), getattr(arch, make)()
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert (c.n_rows, c.catalog_loss_size, c.head_dim) == \
            (jc.n_rows, jc.catalog_loss_size, jc.head_dim)
        assert bert4rec.mask_token_id(c) == jax_b4r.mask_token_id(jc)
    full = arch.make_config()
    assert (full.n_items, full.n_rows, full.catalog_loss_size, full.d_model,
            full.max_len, full.n_layers, full.n_heads, full.causal) == \
        (1_000_000, 1_000_016, 1_000_000, 64, 200, 2, 2, False)
    # the [MASK] row lies outside the loss catalog, as in the reference
    assert bert4rec.mask_token_id(full) >= full.catalog_loss_size
    for field in ("family", "optimizer", "train_loss", "eval_protocol",
                  "dtype", "microbatches", "sce_bucket_size_y"):
        assert getattr(arch, field) == getattr(jarch, field), field
    assert [(s.name, s.kind, dict(s.dims)) for s in arch.shapes] == \
        [(s.name, s.kind, dict(s.dims)) for s in jarch.shapes]


@pytest.mark.parametrize("seed", [0, 1])
def test_bidirectional_forward_matches_jax(model, seed):
    jcfg, cfg, jp, tp = model
    tok = _tokens(cfg, seed=seed)
    want = np.asarray(jax_b4r.forward(jax.tree.map(jnp.asarray, jp), jcfg,
                                      jnp.asarray(tok)))
    got = bert4rec.forward(tp, cfg, torch.from_numpy(tok)).numpy()
    assert got.shape == want.shape == (5, cfg.max_len, cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # every position sees the whole sequence: a change at the last
    # position moves the first position's state (SASRec's would not)
    tok2 = tok.copy()
    tok2[:, -1] = 7
    moved = bert4rec.forward(tp, cfg, torch.from_numpy(tok2)).numpy()
    assert np.abs(moved[0, 0] - got[0, 0]).max() > 1e-4


def test_cloze_mask_matches_jax():
    cfg = get_arch(ARCH).make_smoke_config()
    jcfg = jax_get_arch(ARCH).make_smoke_config()
    tok = _tokens(cfg, b=8, seed=2)
    tok[tok == cfg.n_items] = 3
    key = jax.random.PRNGKey(11)
    want_m, want_is = (np.asarray(a) for a in jax_b4r.apply_cloze_mask(
        key, jnp.asarray(tok), jcfg))
    u = torch.from_numpy(np.array(jax.random.uniform(key, tok.shape)))
    got_m, got_is = bert4rec.apply_cloze_mask(torch.from_numpy(tok), cfg,
                                              uniform=u)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(got_is.numpy(), want_is)
    assert want_is.any() and not want_is[tok == 0].any()
    # drawn from a generator: padding never masked, about 15 % of items
    big = torch.from_numpy(_tokens(cfg, b=400, seed=3))
    m, is_m = bert4rec.apply_cloze_mask(
        big, cfg, generator=torch.Generator().manual_seed(0))
    assert not is_m[big == 0].any()
    assert torch.equal(m[is_m], torch.full_like(m[is_m], cfg.n_items))
    assert torch.equal(m[~is_m], big[~is_m])
    assert abs(is_m[big != 0].float().mean().item() - 0.15) < 0.01
    with pytest.raises(ValueError, match="uniform"):
        bert4rec.apply_cloze_mask(big, cfg, uniform=u)


def test_convert_carries_the_mask_row(model):
    jcfg, cfg, jp, tp = model
    assert tp["item_emb"].shape == (cfg.n_rows, cfg.d_model) == \
        jp["item_emb"].shape
    mask = bert4rec.mask_token_id(cfg)
    np.testing.assert_array_equal(tp["item_emb"][mask].numpy(),
                                  jp["item_emb"][mask])
    for name, leaf in jp["layers"].items():
        np.testing.assert_array_equal(tp["layers"][name].numpy(), leaf)
    init = bert4rec.init_params(cfg, seed=1, device="cpu")
    assert set(init) == set(jp) and set(init["layers"]) == set(jp["layers"])
    assert init["item_emb"].shape == jp["item_emb"].shape
    y = bert4rec.item_embeddings(tp, cfg)
    assert y.shape == (cfg.n_items, cfg.d_model)
    ids = torch.tensor([0, 5, 499])
    h = torch.ones(2, cfg.d_model)
    np.testing.assert_allclose(
        bert4rec.retrieval_scores(tp, cfg, h, ids).numpy(),
        np.asarray(jax_b4r.retrieval_scores(
            jax.tree.map(jnp.asarray, jp), jcfg, jnp.ones((2, cfg.d_model)),
            jnp.asarray(ids.numpy()))), rtol=1e-6, atol=1e-6)


def test_score_fn_and_streaming_eval_match_jax(model):
    """The cloze score function's states, and ``evaluate_streaming``'s
    metrics against the reference's (its plain sweep) and the dense
    oracle."""
    jcfg, cfg, jp, tp = model
    batch, _ = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=48,
    )).eval_batch(Cursor(seed=5))
    tokens, targets = harness._keep_and_targets(batch["tokens"])
    jfn = jax_harness.bert4rec_score_fn(jcfg)
    want_x, want_y = (np.asarray(a) for a in jfn(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(tokens)))
    with torch.no_grad():
        x, y = bert4rec_score_fn(cfg)(tp, torch.from_numpy(tokens))
    assert harness.default_score_fn(cfg).__qualname__.startswith(
        "bert4rec_score_fn")
    np.testing.assert_allclose(x.numpy(), want_x, rtol=0,
                               atol=1e-5 * np.abs(want_x).max())
    np.testing.assert_array_equal(y.numpy(), want_y)
    assert y.shape == (cfg.catalog_loss_size, cfg.d_model)

    # ranks the f64 band leaves open, from the port's states
    s = x.double().numpy() @ y.double().numpy().T
    s[:, 0] = -np.inf
    s[:, cfg.n_items:] = -np.inf
    tol = 1e-5 * np.abs(s[np.isfinite(s)]).max()
    lo, hi = f64_band(x.numpy(), y.numpy(), targets, 1, cfg.n_items, 0, tol)
    t = torch.from_numpy(targets.astype(np.int32))
    _, _, gt, eq, _, _, _ = streaming_eval_scores(x, y, t, max(KS), c_lo=1,
                                                  c_hi=cfg.n_items)
    ranks = ranks_from_counts(gt, eq)
    assert ((ranks >= lo) & (ranks <= hi)).all()
    n_amb = int((lo != hi).sum())
    top = -np.sort(-s, axis=1)[:, :max(KS) + 1]
    got = evaluate_streaming(tp, cfg, batch, ks=KS)
    want = jax_harness.evaluate_streaming(jp, jcfg, batch, ks=KS,
                                          impl="ref")
    assert set(got) == set(want)
    for k in KS:
        for m in ("hr", "ndcg"):
            assert abs(got[f"{m}@{k}"] - want[f"{m}@{k}"]) \
                <= n_amb / len(targets) + 1e-12, (m, k)
        cov_amb = int((top[:, k - 1] - top[:, k] <= tol).sum())
        assert abs(got[f"cov@{k}"] - want[f"cov@{k}"]) \
            <= cov_amb / cfg.n_items + 1e-12


@pytest.fixture(scope="module")
def runs(model):
    """Two SCE steps of the reference and of the port from the same
    state, the cloze masks and Ω injected; per step the loss, grad norm,
    params and the reference's gradient (from its first moment). The
    reference runs its plain selection and loss (``build_sce_config``
    patched to ``use_kernel=False``; its kernels in interpret mode are
    held to those by its own tests and cost this file ≈ 20 s), the port
    its kernel path (on the CPU the kernels' plain versions)."""
    jcfg, cfg, jp0, tp = model
    jarch, arch = jax_get_arch(ARCH), get_arch(ARCH)
    build = jax_steps.build_sce_config
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_steps, "build_sce_config", lambda *a, **kw: build(
        *a, **dict(kw, use_kernel=False)))
    guard.set_policy("off")
    try:
        jstep, (jinit, _), jsce = jax_steps.make_seqrec_train_step(
            jarch, jcfg, None, JaxShapeSpec("train_smoke", "train",
                                            {"batch": BATCH}))
        jstep = jax.jit(jstep)
        tstep, (tinit, _), tsce = steps.make_seqrec_train_step(
            arch, cfg, ShapeSpec("train_smoke", "train", {"batch": BATCH}))
        jp = jax.tree.map(jnp.asarray, jp0)
        js, ts = jinit(jp), tinit(tp)
        tp = tree_map(torch.clone, tp)  # the step updates in place
        data = SequenceDataset(SeqDataConfig(
            n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=BATCH))
        cur = Cursor(seed=0)
        out = {"jax": [], "torch": [], "sce": (jsce, tsce), "masked": []}
        n = BATCH * cfg.max_len
        for i in range(2):
            batch, cur = data.next_batch(cur)
            tokens = {"tokens": batch["tokens"]}
            key = jax.random.PRNGKey(300 + i)
            k_mask, k_loss, _ = jax.random.split(key, 3)
            u = np.asarray(jax.random.uniform(k_mask, tokens["tokens"].shape))
            omega = np.asarray(jax.random.normal(
                k_loss, (jsce.n_buckets, n), jnp.float32))
            out["masked"].append(int(((u < 0.15)
                                      & (tokens["tokens"] != 0)).sum()))
            m_prev = _np_tree(js.inner["m"])
            jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, tokens), key)
            marks = []
            tp, ts, tm = tstep(tp, ts, train.to_device(tokens, "cpu"),
                               omega=torch.from_numpy(omega),
                               cloze=torch.from_numpy(u), mark=marks.append)
            assert marks == ["forward", "select", "loss_forward",
                             "backward", "optimizer"]
            grads = jax.tree.map(
                lambda m, mp: (np.asarray(m) - B1 * mp) / (1 - B1),
                js.inner["m"], m_prev)
            out["jax"].append(dict(
                loss=float(jm["loss"]), grad_norm=float(jm["grad_norm"]),
                skipped=bool(jm["skipped"]), params=_np_tree(jp),
                grads=grads))
            out["torch"].append(dict(
                loss=float(tm["loss"]), grad_norm=float(tm["grad_norm"]),
                skipped=bool(tm["skipped"]),
                params=[p.numpy().copy() for p in tree_leaves(tp)]))
        return out
    finally:
        guard.set_policy(None)
        patch.undo()


def test_train_steps_match_reference(runs):
    jsce, tsce = runs["sce"]
    assert (tsce.n_buckets, tsce.bucket_size_x, tsce.bucket_size_y) == \
        (jsce.n_buckets, jsce.bucket_size_x, jsce.bucket_size_y)
    assert tsce.use_kernel and not jsce.use_kernel
    assert all(n > 0 for n in runs["masked"])
    for i, (j, t) in enumerate(zip(runs["jax"], runs["torch"])):
        assert not t["skipped"] and not j["skipped"]
        assert np.isfinite(t["loss"])
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
        assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-5)
        noisy = [np.zeros(g.shape, bool) for g in jax.tree.leaves(j["grads"])]
        for s in range(i + 1):
            for k, g in enumerate(jax.tree.leaves(runs["jax"][s]["grads"])):
                noisy[k] |= np.abs(g) < 1e-5 * np.abs(g).max()
        for want, got, mask in zip(jax.tree.leaves(j["params"]),
                                   t["params"], noisy):
            diff = np.abs(got - want)
            assert (diff[~mask] <= 1e-5 * np.abs(want).max()).all()
            assert (diff[mask] <= 2 * LR * (i + 1)).all()


def test_microbatched_cloze_step_matches_reference():
    """BERT4Rec's train shape, 2 microbatches (``train_batch``'s 8 capped
    by the batch): each microbatch's mask from its own key,
    ``split(fold_in(key, i), 3)[0]``, injected as one (B, L) draw; the
    full CE (no other draw), so the mean loss and gradient test the
    per-microbatch masks alone."""
    jarch = dataclasses.replace(jax_get_arch(ARCH), train_loss="ce")
    arch = dataclasses.replace(get_arch(ARCH), train_loss="ce")
    jcfg, cfg = jarch.make_smoke_config(), arch.make_smoke_config()
    jstep, (jinit, _), _ = jax_steps.make_seqrec_train_step(
        jarch, jcfg, None, JaxShapeSpec("train_batch", "train",
                                        {"batch": BATCH}))
    tstep, (tinit, _), _ = steps.make_seqrec_train_step(
        arch, cfg, ShapeSpec("train_batch", "train", {"batch": BATCH}))
    jp = jax_b4r.init_params(jax.random.PRNGKey(4), jcfg)
    tp = sasrec_params_from_jax(_np_tree(jp), device="cpu")
    batch, _ = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len,
        batch_size=BATCH)).next_batch(Cursor(seed=1))
    tokens = {"tokens": batch["tokens"]}
    key = jax.random.PRNGKey(9)
    u = np.concatenate([np.asarray(jax.random.uniform(
        jax.random.split(jax.random.fold_in(key, i), 3)[0],
        (1, cfg.max_len))) for i in range(BATCH)])
    guard.set_policy("off")
    try:
        _, _, jm = jax.jit(jstep)(jp, jinit(jp),
                                  jax.tree.map(jnp.asarray, tokens), key)
    finally:
        guard.set_policy(None)
    _, _, tm = tstep(tp, tinit(tp), train.to_device(tokens, "cpu"),
                     cloze=torch.from_numpy(u))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)


def test_cloze_injection_is_bert4rec_only():
    arch = get_arch("sasrec-sce")
    cfg = arch.make_smoke_config()
    step, (opt_init, _), _ = steps.make_seqrec_train_step(
        arch, cfg, ShapeSpec("train_smoke", "train", {"batch": BATCH}))
    params = sasrec.init_params(cfg, seed=0, device="cpu")
    batch, _ = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len,
        batch_size=BATCH)).next_batch(Cursor(seed=0))
    with pytest.raises(ValueError, match="cloze"):
        step(params, opt_init(params), train.to_device(batch, "cpu"),
             cloze=torch.zeros(BATCH, cfg.max_len))


def test_trainer_trains_bert4rec_on_tokens_in_microbatches(monkeypatch):
    """``train("bert4rec")``: tokens-only batches, train_batch's
    microbatches at the run's batch (2 here), every phase marked per
    microbatch, finite losses, the cloze eval at the end."""
    seen = []
    real = train.to_device

    def recording(batch, device):
        seen.append(sorted(batch))
        return real(batch, device)

    monkeypatch.setattr(train, "to_device", recording)
    marks = []
    out = train.train(ARCH, steps=2, batch=2, device="cpu", eval_every=2,
                      eval_users=16, mark=marks.append)
    assert seen == [["tokens"], ["tokens"]]
    assert out["steps"] == 2 and all(np.isfinite(out["losses"]))
    micro = ["forward", "select", "loss_forward", "backward"]
    assert marks == 2 * (["start", "h2d"] + 2 * micro + ["optimizer"])
    assert set(out["eval"]) == {f"{m}@{k}" for m in ("hr", "ndcg", "cov")
                                for k in KS}
