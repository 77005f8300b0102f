"""The port's leave-one-out evaluation against the JAX package's.

The data split and the metric bookkeeping do no float arithmetic that
could differ, so they must agree exactly (held-out batches bit for bit,
accumulated metrics to the last bit of a float64 sum in the same order).

The streaming evaluation runs the same SASRec weights
(``sasrec_params_from_jax``) through both packages. Their states differ
by f32 fold noise, so a target's rank is only defined up to the other
scores within ``1e-5·max|score|`` of it: every rank of the port must lie
inside the band a dense f64 oracle allows (``f64_band``), and the
metrics must equal the reference's wherever the ranks (HR, NDCG) or the
top-k boundary (COV) are unambiguous — each ambiguous row may move a
metric by at most one user's (or one item's) share.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import metrics as jax_metrics
from repro.data import Cursor as JaxCursor
from repro.data import SeqDataConfig as JaxSeqDataConfig
from repro.data import SequenceDataset as JaxSequenceDataset
from repro.data import pipeline as jax_pipeline
from repro.eval import harness as jax_harness
from repro.eval import streaming as jax_streaming
from repro.models import sasrec as jax_sasrec
from repro_torch.configs import get_arch
from repro_torch.core import metrics
from repro_torch.data import SPLIT_SALTS, Cursor, SeqDataConfig, \
    SequenceDataset
from repro_torch.eval import (
    MetricAccumulator,
    dense_eval_elements,
    eval_peak_elements,
    evaluate_streaming,
    ranks_from_counts,
    sasrec_score_fn,
    streaming_eval_scores,
    streaming_rank_topk,
)
from repro_torch.eval import harness
from repro_torch.launch import train
from repro_torch.models.convert import sasrec_params_from_jax
from _rank_band import f64_band

KS = (1, 5, 10)
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    """The smoke SASRec with the same random weights in both packages,
    and one held-out batch of 64 users."""
    import jax

    cfg = get_arch("sasrec-sce").make_smoke_config()
    jcfg = jax_get_arch("sasrec-sce").make_smoke_config()
    jp = jax_sasrec.init_params(jax.random.PRNGKey(3), jcfg)
    tp = sasrec_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    batch, _ = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=64,
    )).eval_batch(Cursor(seed=7))
    return cfg, jcfg, jp, tp, batch


def _ambiguity(cfg, tp, batch):
    """Rows whose rank (HR/NDCG) or top-k boundary (COV@k) is ambiguous
    within ``TOL·max|score|``, from the port's own states in f64; and
    the port's streaming ranks, held against the band."""
    tokens, targets = harness._keep_and_targets(batch["tokens"])
    with torch.no_grad():
        states, catalog = sasrec_score_fn(cfg)(tp, torch.from_numpy(tokens))
        _, _, gt, eq, _, _, _ = streaming_eval_scores(
            states, catalog, torch.from_numpy(targets.astype(np.int32)),
            max(KS), c_lo=1, c_hi=cfg.n_items)
    x, y = states.numpy(), catalog.numpy()
    s = x.astype(np.float64) @ y.astype(np.float64).T
    s[:, 0] = -np.inf
    s[:, cfg.n_items:] = -np.inf
    tol = TOL * np.abs(s[np.isfinite(s)]).max()
    lo, hi = f64_band(x, y, targets, 1, cfg.n_items, 0, tol)
    ranks = ranks_from_counts(gt, eq)
    assert ((ranks >= lo) & (ranks <= hi)).all()
    top = -np.sort(-s, axis=1)[:, :max(KS) + 1]
    cov_amb = {k: int((top[:, k - 1] - top[:, k] <= tol).sum()) for k in KS}
    return int((lo != hi).sum()), cov_amb, len(targets)


def _assert_metrics_close(got, want, n_amb, cov_amb, n_users, catalog):
    assert set(got) == set(want)
    for k in KS:
        for m in ("hr", "ndcg"):
            assert abs(got[f"{m}@{k}"] - want[f"{m}@{k}"]) \
                <= n_amb / n_users, (m, k)
            if n_amb == 0:
                assert got[f"{m}@{k}"] == pytest.approx(want[f"{m}@{k}"],
                                                        rel=1e-12)
        assert abs(got[f"cov@{k}"] - want[f"cov@{k}"]) \
            <= cov_amb[k] / catalog + 1e-12, k


# ---------------------------------------------------------------------------
# Data split and held-out batches
# ---------------------------------------------------------------------------
def test_split_salts_and_cursor_split_match_reference():
    assert SPLIT_SALTS == jax_pipeline.SPLIT_SALTS
    for name in SPLIT_SALTS:
        a = Cursor(seed=11, step=4).split(name)
        b = JaxCursor(seed=11, step=4).split(name)
        assert (a.seed, a.step) == (b.seed, b.step)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 3), (5, 1)])
def test_eval_batch_is_bit_identical(seed, step):
    kw = dict(n_items=300, seq_len=20, batch_size=16)
    got, gcur = SequenceDataset(SeqDataConfig(**kw)).eval_batch(
        Cursor(seed=seed, step=step))
    want, wcur = JaxSequenceDataset(JaxSeqDataConfig(**kw)).eval_batch(
        JaxCursor(seed=seed, step=step))
    assert (gcur.seed, gcur.step) == (wcur.seed, wcur.step)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    train_batch, _ = SequenceDataset(SeqDataConfig(**kw)).next_batch(
        Cursor(seed=seed, step=step))
    assert not np.array_equal(train_batch["tokens"], got["tokens"])


# ---------------------------------------------------------------------------
# Metric bookkeeping
# ---------------------------------------------------------------------------
def test_metric_accumulator_over_batches_matches_reference():
    rng = np.random.default_rng(0)
    got, want = MetricAccumulator(KS, 400), jax_streaming.MetricAccumulator(
        KS, 400)
    for b in (17, 1, 40):
        gt = rng.integers(0, 30, size=b).astype(np.int32)
        eq = rng.integers(0, 3, size=b).astype(np.int32)
        ids = rng.integers(0, 400, size=(b, 12)).astype(np.int32)
        ids[0, 8:] = 2**31 - 1  # an ID_PAD tail
        np.testing.assert_array_equal(ranks_from_counts(gt, eq),
                                      jax_streaming.ranks_from_counts(gt, eq))
        got.update(ranks_from_counts(torch.from_numpy(gt),
                                     torch.from_numpy(eq)),
                   torch.from_numpy(ids))
        want.update(jax_streaming.ranks_from_counts(gt, eq), ids)
    assert got.n_users == want.n_users == 58
    assert got.result() == want.result()


def test_memory_models_match_reference():
    for b, k, bc in ((128, 10, 512), (256, 10, 512), (7, 3, 64)):
        assert eval_peak_elements(b, k, bc) == \
            jax_streaming.eval_peak_elements(b, k, bc)
    assert dense_eval_elements(256, 173_520) == \
        jax_streaming.dense_eval_elements(256, 173_520)


def test_dense_oracle_matches_reference():
    rng = np.random.default_rng(1)
    scores = rng.integers(-3, 4, size=(20, 50)).astype(np.float32)
    scores[:, 0] = -np.inf
    targets = rng.integers(1, 50, size=20)
    np.testing.assert_array_equal(
        metrics.rank_of_target(torch.from_numpy(scores),
                               torch.from_numpy(targets)).numpy(),
        np.asarray(jax_metrics.rank_of_target(scores, targets)))
    assert metrics.topk_metrics(scores, targets, KS, catalog=60) == \
        jax_metrics.topk_metrics(scores, targets, KS, catalog=60)


def test_evaluate_seqrec_matches_reference(model):
    cfg, jcfg, jp, tp, batch = model
    n_amb, cov_amb, n = _ambiguity(cfg, tp, batch)
    got = metrics.evaluate_seqrec(tp, cfg, batch, ks=KS)
    want = jax_metrics.evaluate_seqrec(jp, jcfg, batch, ks=KS)
    _assert_metrics_close(got, want, n_amb, cov_amb, n, cfg.n_items)


# ---------------------------------------------------------------------------
# The streaming evaluation, end to end
# ---------------------------------------------------------------------------
def test_evaluate_streaming_matches_reference_and_dense_oracle(model):
    cfg, jcfg, jp, tp, batch = model
    n_amb, cov_amb, n = _ambiguity(cfg, tp, batch)
    got = evaluate_streaming(tp, cfg, batch, ks=KS, block_c=128)
    want = jax_harness.evaluate_streaming(jp, jcfg, batch, ks=KS,
                                          block_c=128, impl="ref")
    _assert_metrics_close(got, want, n_amb, cov_amb, n, cfg.n_items)
    dense = metrics.evaluate_seqrec(tp, cfg, batch, ks=KS)
    _assert_metrics_close(got, dense, n_amb, cov_amb, n, cfg.n_items)


def test_evaluate_streaming_folds_batches_like_reference(model):
    cfg, jcfg, jp, tp, _ = model
    data = SequenceDataset(SeqDataConfig(
        n_items=cfg.n_items, seq_len=cfg.max_len, batch_size=24))
    acc, jacc = MetricAccumulator(KS, cfg.n_items), \
        jax_streaming.MetricAccumulator(KS, cfg.n_items)
    n_amb, cov_amb, n = 0, dict.fromkeys(KS, 0), 0
    for step in range(3):
        batch, _ = data.eval_batch(Cursor(seed=2, step=step))
        a, c, m = _ambiguity(cfg, tp, batch)
        n_amb, n = n_amb + a, n + m
        cov_amb = {k: cov_amb[k] + c[k] for k in KS}
        got = evaluate_streaming(tp, cfg, batch, ks=KS, accumulator=acc)
        want = jax_harness.evaluate_streaming(jp, jcfg, batch, ks=KS,
                                              impl="ref", accumulator=jacc)
    assert acc.n_users == jacc.n_users == n
    _assert_metrics_close(got, want, n_amb, cov_amb, n, cfg.n_items)


def test_evaluate_streaming_marks_each_phase_in_order(model):
    """The ``mark`` hook sees every phase of every evaluation, in order,
    and changes nothing it computes; the rank slice of the sweep is the
    first four outputs of the whole sweep."""
    cfg, _, _, tp, batch = model
    seen = []
    got = evaluate_streaming(tp, cfg, batch, ks=KS, mark=seen.append)
    assert seen == ["start", "h2d", "forward", "sweep", "fold"]
    assert got == evaluate_streaming(tp, cfg, batch, ks=KS)
    tokens, targets = harness._keep_and_targets(batch["tokens"])
    with torch.no_grad():
        states, catalog = sasrec_score_fn(cfg)(tp, torch.from_numpy(tokens))
    t = torch.from_numpy(targets.astype(np.int32))
    whole = streaming_eval_scores(states, catalog, t, 10, c_lo=1,
                                  c_hi=cfg.n_items)
    for a, b in zip(streaming_rank_topk(states, catalog, t, 10, c_lo=1,
                                        c_hi=cfg.n_items), whole[:4]):
        assert torch.equal(a, b)


def test_evaluate_streaming_refuses_what_is_not_ported(model):
    """Nothing is refused any more: the sharded path on a (1, 1) mesh is
    the one-device evaluation (its meshes of several ranks are
    ``tests/test_torch_dist_infer.py``'s), and a bidirectional config
    takes BERT4Rec's cloze score function by default."""
    from repro_torch.dist.sharding import make_mesh

    cfg, _, _, tp, batch = model
    assert evaluate_streaming(tp, cfg, batch, mesh=make_mesh((1, 1))) == \
        evaluate_streaming(tp, cfg, batch)
    bidir = dataclasses.replace(cfg, causal=False)
    assert harness.default_score_fn(bidir).__qualname__.startswith(
        "bert4rec_score_fn")
    got = evaluate_streaming(tp, bidir, batch, ks=KS)
    assert set(got) == {f"{m}@{k}" for m in ("hr", "ndcg", "cov")
                        for k in KS}


# ---------------------------------------------------------------------------
# In-loop evaluation of the trainer
# ---------------------------------------------------------------------------
def test_trainer_evaluates_every_n_steps(capsys):
    out = train.train("sasrec-sce", steps=4, batch=3, device="cpu",
                      log_every=0, eval_every=2, eval_users=32)
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[eval]")]
    assert [l.split(":")[0] for l in lines] == ["[eval] step 1",
                                                "[eval] step 3"]
    assert set(out["eval"]) == {f"{m}@{k}" for m in ("hr", "ndcg", "cov")
                                for k in KS}
    assert all(0.0 <= v <= 1.0 for v in out["eval"].values())
    assert len(out["step_s"]) == 4
    plain = train.train("sasrec-sce", steps=4, batch=3, device="cpu",
                        log_every=0)
    assert "eval" not in plain and plain["losses"] == out["losses"]


def test_train_cli_eval_every(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "sasrec-sce", "--steps", "2", "--batch", "2",
        "--eval-every", "2", "--eval-users", "16", "--device", "cpu",
        "--log-every", "0",
    ])
    train.main()
    out = capsys.readouterr().out
    assert "[eval] step 1: {" in out and '"eval": {' in out


def test_evaluation_without_device_needs_cuda(monkeypatch):
    """No device given and no CUDA: the trainer with evaluation raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train("sasrec-sce", steps=1, eval_every=1)
