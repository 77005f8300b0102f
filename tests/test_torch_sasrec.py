"""The port's SASRec against the JAX package's.

JAX parameters (``repro.models.sasrec.init_params``) go through
``sasrec_params_from_jax`` as numpy arrays; both forwards then run on the
same 0-padded histories. Hidden states agree within ``1e-5·max|h|``: the
two frameworks fold f32 sums (matmuls, softmax, LayerNorm means) in
another order, nothing more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import sasrec as jax_sasrec
from repro_torch.configs import get_arch
from repro_torch.models import sasrec
from repro_torch.models.convert import sasrec_params_from_jax


def _jax_params(seed=0):
    """JAX smoke-config parameters as (writable) numpy arrays."""
    jcfg = jax_get_arch("sasrec-sce").make_smoke_config()
    params = jax_sasrec.init_params(jax.random.PRNGKey(seed), jcfg)
    return jax.tree.map(np.array, params)


def _tokens(cfg, b=5, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.n_items, size=(b, cfg.max_len)).astype(np.int32)
    lengths = rng.integers(1, cfg.max_len + 1, size=b)
    lengths[0] = cfg.max_len  # one unpadded history
    pos = np.arange(cfg.max_len)[None, :]
    return np.where(pos >= cfg.max_len - lengths[:, None], tok, 0).astype(
        np.int32
    )  # front-padded with 0, like the data pipeline


def test_configs_match_reference():
    jarch, arch = jax_get_arch("sasrec-sce"), get_arch("sasrec-sce")
    for make in ("make_config", "make_smoke_config"):
        jc, c = getattr(jarch, make)(), getattr(arch, make)()
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert (c.n_rows, c.catalog_loss_size, c.head_dim, c.d_ff_actual) \
            == (jc.n_rows, jc.catalog_loss_size, jc.head_dim, jc.d_ff_actual)
    full = arch.make_config()
    assert (full.n_items, full.n_rows, full.d_model, full.max_len) == \
        (173_511, 173_520, 64, 200)
    assert arch.shape("serve_p99").dims == {"batch": 512}


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed):
    cfg = get_arch("sasrec-sce").make_smoke_config()
    jcfg = jax_get_arch("sasrec-sce").make_smoke_config()
    jp = _jax_params(seed)
    # Non-trivial norms and biases, so their layout is exercised too.
    rng = np.random.default_rng(seed)
    for name in ("b1", "b2", "ln1_b", "ln2_b"):
        jp["layers"][name] = rng.normal(
            scale=0.1, size=jp["layers"][name].shape
        ).astype(np.float32)
    for name in ("ln1_g", "ln2_g"):
        jp["layers"][name] = (1 + rng.normal(
            scale=0.1, size=jp["layers"][name].shape
        )).astype(np.float32)
    tok = _tokens(cfg, seed=seed)
    want = np.asarray(jax_sasrec.forward(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(tok)
    ))
    got = sasrec.forward(
        sasrec_params_from_jax(jp, device="cpu"), cfg, torch.from_numpy(tok)
    ).numpy()
    assert got.shape == want.shape == (5, cfg.max_len, cfg.d_model)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_convert_is_a_copy_in_the_reference_layout():
    cfg = get_arch("sasrec-sce").make_smoke_config()
    jp = _jax_params()
    tp = sasrec_params_from_jax(jp, device="cpu")
    for name in ("item_emb", "pos_emb", "ln_f_g", "ln_f_b"):
        np.testing.assert_array_equal(tp[name].numpy(), jp[name])
    for name, leaf in jp["layers"].items():
        np.testing.assert_array_equal(tp["layers"][name].numpy(), leaf)
    assert tp["layers"]["wqkv"].shape == (
        cfg.n_layers, cfg.d_model, 3 * cfg.d_model
    )
    jp["item_emb"][0, 0] += 1.0  # a copy: the source can change freely
    assert tp["item_emb"][0, 0].item() != jp["item_emb"][0, 0]
    bad = dict(jp)
    del bad["pos_emb"]
    with pytest.raises(KeyError):
        sasrec_params_from_jax(bad, device="cpu")


def test_init_params_matches_reference_structure():
    cfg = get_arch("sasrec-sce").make_smoke_config()
    jp = _jax_params()
    tp = sasrec.init_params(cfg, seed=3, device="cpu")
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for name in ("item_emb", "pos_emb", "ln_f_g", "ln_f_b"):
        assert tuple(tp[name].shape) == jp[name].shape
    for name, leaf in jp["layers"].items():
        assert tuple(tp["layers"][name].shape) == leaf.shape
        assert tp["layers"][name].dtype == torch.float32
    # Truncated-normal fan-in init: within ±2/sqrt(fan_in).
    w = tp["layers"]["w1"]
    assert w.abs().max().item() <= 2.0 / cfg.d_model**0.5 + 1e-6
    again = sasrec.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(again["item_emb"], tp["item_emb"])  # seeded


@pytest.mark.parametrize("entry", ["init_params", "sasrec_params_from_jax"])
def test_weights_default_device_needs_cuda(monkeypatch, entry):
    """With no device given and no CUDA, the weight entry points raise
    rather than leaving the weights on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("sasrec-sce").make_smoke_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "init_params":
            sasrec.init_params(cfg, seed=0)
        else:
            sasrec_params_from_jax(_jax_params())


def test_catalog_views():
    cfg = get_arch("sasrec-sce").make_smoke_config()
    tp = sasrec.init_params(cfg, seed=0, device="cpu")
    y = sasrec.loss_catalog(tp, cfg)
    assert y.shape == (cfg.catalog_loss_size, cfg.d_model)
    assert y.data_ptr() == tp["item_emb"].data_ptr() and y.is_contiguous()
    assert sasrec.item_embeddings(tp, cfg).shape == (cfg.n_items, cfg.d_model)
    h = torch.ones(3, cfg.d_model)
    assert sasrec.score_all(tp, cfg, h).shape == (3, cfg.n_items)
