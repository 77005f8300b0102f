"""The port's transformer LM (``repro_torch/models/layers.py``,
``models/transformer.py``) against the JAX package's, on the CPU.

Both sides run the same weights: ``repro.models.transformer.init_params``
draws them, ``models/convert.py::transformer_params_from_jax`` carries
them across. The configs are the smoke configs of gemma-2-2b (local and
global attention, both softcaps, post-block norms, tied and scaled
embeddings, GQA), yi-6b (untied, plain llama), the two MoE LMs —
granite-moe-3b-a800m (4 experts, top-2, padded to 16) and kimi-k2 (8
experts, top-2, a shared expert, untied) — and gemma-2's with a
vocabulary of 1000, whose 8 padded rows are phantoms. Inputs are numpy
draws from a seed. Tolerances: values within ``2e-5`` of the tensor's
largest magnitude (f32 sums in another order), gradients within
``1e-4`` of theirs; the MoE balance loss within ``1e-5`` relative. The
MoE models route the same tokens on both sides (drops included: the
smoke configs' capacity factor 1.25 drops assignments at these lengths);
the check of the last decode step against a forward runs them with a
capacity factor at which nothing can drop (``n_experts / top_k``), since
a forward over the whole sequence drops other assignments than the
prefill and the one-token decode steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import transformer_params_from_jax
from repro_torch.models.moe import MoEConfig, count_drops


def _close(got, want, tol=2e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol * scale, (err, scale)


def _configs(name):
    """(reference cfg, port cfg) of the named variant."""
    arch = {"gemma": "gemma2-2b", "gemma1000": "gemma2-2b",
            "yi": "yi-6b", "granite": "granite-moe-3b-a800m",
            "kimi": "kimi-k2-1t-a32b"}[name]
    jcfg = jax_get_arch(arch).make_smoke_config()
    if name == "gemma1000":
        jcfg = dataclasses.replace(jcfg, vocab=1000)
    return jcfg, port_config(jcfg)


def port_config(jcfg):
    """The port's TransformerConfig (and MoEConfig) of a reference one."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ttf.TransformerConfig)}
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**{f.name: getattr(jcfg.moe, f.name)
                                 for f in dataclasses.fields(MoEConfig)})
    return ttf.TransformerConfig(**kw)


def _no_drops(jcfg):
    """The config with a capacity factor at which no assignment drops."""
    moe = dataclasses.replace(
        jcfg.moe, capacity_factor=jcfg.moe.n_experts / jcfg.moe.top_k)
    return dataclasses.replace(jcfg, moe=moe)


def _params(jcfg, seed=0):
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return jp, tp


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(1, vocab, (b, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def test_rms_norm_rope_and_swiglu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(g)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(g)))
    pos = np.arange(5)[None, :] + 7
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0))
    _close(tl.rope_frequencies(16, 500.0), jl.rope_frequencies(16, 500.0))
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_gate", (16, 24)), ("w_up", (16, 24)),
                      ("w_down", (24, 16)))}
    h = x.reshape(-1, 16)
    _close(tl.swiglu({k: torch.from_numpy(v) for k, v in w.items()},
                     torch.from_numpy(h)),
           jl.swiglu({k: jnp.asarray(v) for k, v in w.items()},
                     jnp.asarray(h)))


@pytest.mark.parametrize("lq,lk,causal,window,softcap,q_offset,valid,chunk", [
    (12, 12, True, None, None, 0, False, 1024),   # grouped, causal
    (12, 12, True, 5, 50.0, 0, False, 1024),      # local window, softcap
    (1, 20, False, None, 50.0, 9, True, 1024),    # a decode step
    (32, 32, True, 16, 50.0, 0, False, 8),        # the long-q path, chunks
    (32, 32, True, None, None, 0, False, 16),
])
def test_attention_matches_reference(lq, lk, causal, window, softcap,
                                     q_offset, valid, chunk):
    rng = np.random.default_rng(lq + lk)
    q = rng.standard_normal((2, lq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, lk, 2, 16)).astype(np.float32) * 2
    v = rng.standard_normal((2, lk, 2, 16)).astype(np.float32)
    kv_valid = (rng.random((2, lk)) > 0.3) if valid else None
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, q_chunk=chunk)
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        kv_valid=None if kv_valid is None
                        else jnp.asarray(kv_valid), **kw)
    got = tl.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           kv_valid=None if kv_valid is None
                           else torch.from_numpy(kv_valid), **kw)
    _close(got, want)


def test_long_q_attention_gradient_matches_reference():
    """The chunked path checkpoints each chunk; its gradients equal
    jax.grad's through the reference's scan of checkpointed chunks."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 32, s, 16)).astype(np.float32)
               for s in (4, 2, 2))
    w = rng.standard_normal((1, 32, 4, 16)).astype(np.float32)
    kw = dict(causal=True, window=12, softcap=50.0, q_chunk=8)

    def jloss(q, k, v):
        return jnp.sum(jl.attention(q, k, v, **kw) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tl.gqa_attention(*leaves, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["gemma", "yi", "gemma1000", "granite",
                                  "kimi"])
def test_forward_and_logits_match_reference(name):
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg)
    tok = _tokens(jcfg.vocab, 2, 24)
    jh, jaux = jax.jit(jtf.forward, static_argnums=1)(jp, jcfg,
                                                      jnp.asarray(tok))
    th, taux = ttf.forward(tp, cfg, torch.from_numpy(tok))
    _close(th, jh)
    if cfg.moe is None:
        assert float(taux) == float(jaux) == 0.0
    else:
        assert float(jaux) > 0
        assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
        assert cfg.active_param_count() == jcfg.active_param_count()
    jl_ = jtf.logits_from_hidden(jp, jcfg, jh)
    tl_ = ttf.logits_from_hidden(tp, cfg, th)
    _close(tl_, jl_)
    if cfg.vocab_padded != cfg.vocab:  # the phantom rows
        assert (tl_[..., cfg.vocab:] == -1e30).all()
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("name,remat,q_chunk", [
    ("gemma", False, 1024), ("gemma", True, 8), ("yi", True, 1024),
    ("granite", True, 8), ("kimi", False, 1024)])
def test_forward_gradients_match_reference(name, remat, q_chunk):
    """jax.grad and autograd of one linear functional of the hidden
    states (plus 10 × the MoE balance loss) agree on every parameter,
    with the layer groups checkpointed (``remat``) or not, through the
    long-q path or not."""
    jcfg, cfg = _configs(name)
    jcfg = dataclasses.replace(jcfg, remat=remat, q_chunk=q_chunk)
    cfg = dataclasses.replace(cfg, remat=remat, q_chunk=q_chunk)
    jp, tp = _params(jcfg, seed=2)
    tok = _tokens(jcfg.vocab, 2, 16)
    w = np.random.default_rng(4).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    def jloss(p):
        h, aux = jtf.forward(p, jcfg, jnp.asarray(tok))
        return jnp.sum(h * w) + 10.0 * aux

    want = jax.jit(jax.grad(jloss))(jp)
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    flat = tree_leaves(leaves)
    h, aux = ttf.forward(leaves, cfg, torch.from_numpy(tok))
    out = (h * torch.from_numpy(w)).sum() + 10.0 * aux
    got = torch.autograd.grad(out, flat, allow_unused=True)
    for t, a, b in zip(flat, got, jax.tree.leaves(want)):
        if a is None:  # yi's untied unembed: no part in the hidden states
            assert not np.asarray(b).any()
            continue
        _close(a, b, 1e-4)


def _prefill_decode(jp, jcfg, tp, cfg, tok, n_prompt):
    """Prefill ``n_prompt`` tokens and decode the rest on both sides (the
    reference's jitted), holding the caches and every step's logits to
    the reference's → the port's last logits."""
    prompt, rest = tok[:, :n_prompt], tok[:, n_prompt:]
    cache_len = tok.shape[1]
    jh, jc = jax.jit(jtf.prefill, static_argnums=1,
                     static_argnames="cache_len")(
        jp, jcfg, jnp.asarray(prompt), cache_len=cache_len)
    th, tc = ttf.prefill(tp, cfg, torch.from_numpy(prompt),
                         cache_len=cache_len)
    _close(th, jh)
    assert sorted(tc) == sorted(jc)
    for key in jc:
        _close(tc[key], jc[key])
    pos = n_prompt
    logits = None
    jdecode = jax.jit(jtf.decode_step, static_argnums=1)
    for j in range(rest.shape[1]):
        step = rest[:, j:j + 1]
        jlog, jc = jdecode(jp, jcfg, jc, jnp.asarray(step), pos)
        logits, tc = ttf.decode_step(tp, cfg, tc, torch.from_numpy(step), pos)
        _close(logits, jlog)
        pos += 1
    return logits


@pytest.mark.parametrize("name", ["gemma", "yi", "granite", "kimi"])
def test_prefill_and_decode_match_reference(name):
    """A prompt of 20 tokens (gemma's local window is 16, so its rolling
    cache wraps) and 6 decode steps: the caches and every step's logits
    equal the reference's, and the last step's logits those of a forward
    over all 26 tokens (an MoE model's at a capacity factor at which the
    prefill, the decode steps and the forward drop nothing: counted)."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, seed=3)
    tok = _tokens(jcfg.vocab, 2, 26, seed=5)
    logits = _prefill_decode(jp, jcfg, tp, cfg, tok, 20)
    if cfg.moe is not None:
        jcfg = _no_drops(jcfg)
        cfg = port_config(jcfg)
        with count_drops() as drops:
            logits = _prefill_decode(jp, jcfg, tp, cfg, tok, 20)
            full, _ = ttf.forward(tp, cfg, torch.from_numpy(tok))
        n_calls = cfg.n_layers * (1 + 6 + 1)  # prefill, decodes, forward
        assert len(drops) == n_calls
        assert sum(int(n) for n, _ in drops) == 0
    else:
        full, _ = ttf.forward(tp, cfg, torch.from_numpy(tok))
    # the last decode step's logits are the forward's at that position
    # (teacher forcing: the decoded tokens are the sequence's own)
    want = ttf.logits_from_hidden(tp, cfg, full[:, -1:])
    _close(logits, want.detach().numpy(), 1e-4)
    empty = ttf.init_cache(cfg, 2, tok.shape[1])
    jempty = jtf.init_cache(jcfg, 2, tok.shape[1])
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: tuple(v.shape) for k, v in jempty.items()}


def test_init_params_has_the_reference_layout():
    _hold_init_layout("gemma")


@pytest.mark.parametrize("name", ["granite", "kimi"])
def test_moe_init_params_has_the_reference_layout(name):
    """``layers["moe"]`` in place of ``mlp``: the router, the padded
    experts and kimi-k2's shared expert, with the reference's shapes."""
    _hold_init_layout(name)


def _hold_init_layout(name):
    jcfg, cfg = _configs(name)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttf.init_params(cfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    from repro_torch.optim.optimizers import tree_map
    assert tree_map(lambda t: tuple(t.shape), tp) == shapes
    again = ttf.init_params(cfg, seed=0, device="cpu")
    from repro_torch.optim.optimizers import tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp),
                                                 tree_leaves(again)))
