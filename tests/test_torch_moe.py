"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``), on the CPU.

Both sides take the same numpy weights (the reference's ``init_moe``)
and inputs drawn from a seed. Configurations: with drops (capacity
factor 0.25) and without (4.0), padded experts (6 → 16, 4 → 16, 40 →
48) and unpadded ones (8 of 8), with and without a shared expert, and
granite's routing pattern (40 experts, top-8) at a narrow width.

Tolerances:
- the routing — expert ids, ranks, keep masks, dispatch indices —
  equal exactly, after the inputs are checked to hold no near-tie (the
  k-th and (k+1)-th probabilities of every token at least ``1e-5``
  apart); a forced tie picks the lower expert id on both sides;
- the combine weights within ``1e-6`` of 1 (f32 softmax and
  renormalisation in another order);
- outputs within ``2e-6`` of the output's largest magnitude (f32 sums in
  another order through three products and the combine), ``aux`` within
  ``1e-6`` relative;
- gradients of ``sum(y · w) + 10·aux`` with respect to ``x`` and every
  weight within ``1e-5`` of each gradient's largest magnitude of
  ``jax.grad``'s;
- in bf16 (weights and input), outputs within ``3e-2`` of their largest
  magnitude (the reference adds the expert outputs in bf16, the port in
  f32 rounded once; ROADMAP "Known deviations").
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

D = 32


def _cfgs(n_experts, top_k, cf, pad, shared, d_ff=16):
    j = jmoe.MoEConfig(n_experts=n_experts, top_k=top_k, d_ff=d_ff,
                       capacity_factor=cf, n_shared_experts=shared,
                       expert_pad_multiple=pad)
    t = tmoe.MoEConfig(**{f.name: getattr(j, f.name)
                          for f in dataclasses.fields(tmoe.MoEConfig)})
    return j, t


def _params(jcfg, seed=0, dtype=jnp.float32):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, jcfg, dtype=dtype)
    tp = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32),
        jp)
    return jp, tp


def _x(b, l, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, l, D)).astype(np.float32)


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol * scale, (err, scale)


CASES = {
    # name: (n_experts, top_k, capacity factor, pad multiple, shared)
    "drops_padded": (6, 2, 0.25, 16, 0),
    "nodrops_padded": (4, 2, 4.0, 16, 0),
    "drops_unpadded_shared": (8, 2, 0.25, 8, 1),
    "nodrops_unpadded_shared": (8, 2, 4.0, 8, 1),
    "granite_pattern": (40, 8, 1.25, 16, 0),
    "kimi_pattern_drops": (8, 2, 0.25, 16, 1),
}


def _reference_routing(jp, x, jcfg):
    """The reference's routing of every row: (top_e, rank, keep,
    dispatch_idx, combine_w, probs), as ``_dispatch_one_row`` computes
    them."""
    b, l, _ = x.shape
    cap = max(1, int(l * jcfg.top_k * jcfg.capacity_factor
                     / jcfg.n_experts))
    logits = jnp.einsum("bld,de->ble", jnp.asarray(x, jnp.float32),
                        jp["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, jcfg.top_k)
    flat_e = top_e.reshape(b, -1)
    rank = jax.vmap(lambda e: jmoe._rank_within_expert(e, jcfg.n_experts))(
        flat_e)
    _, idx, comb, _ = jax.vmap(
        lambda xr, lr: jmoe._dispatch_one_row(xr, lr, jcfg, cap))(
        jnp.asarray(x), logits)
    return (np.asarray(flat_e), np.asarray(rank), np.asarray(rank) < cap,
            np.asarray(idx), np.asarray(comb), np.asarray(probs))


def _combine_w(r, cfg):
    """The port's router weight per (expert, slot), the reference's
    ``combine_w`` (0 in an empty slot)."""
    b, e = r.slot.shape[0], cfg.n_experts_padded
    c = r.dispatch_idx.shape[-1]
    comb = torch.zeros(b, e * c + 1).scatter_(-1, r.slot, r.weight)
    return comb[:, :-1].reshape(b, e, c)


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_moe_matches_reference(name):
    jcfg, cfg = _cfgs(*CASES[name])
    jp, tp = _params(jcfg)
    x = _x(3, 24)
    top_e, rank, keep, idx, comb, probs = _reference_routing(jp, x, jcfg)
    # no near-tie at the k-th choice: the routing must then be equal
    srt = -np.sort(-probs, axis=-1)
    assert (srt[..., cfg.top_k - 1] - srt[..., cfg.top_k] > 1e-5).all()
    drops = int((~keep).sum())
    if cfg.capacity_factor < 1:  # these inputs do drop
        assert drops > 0
    if cfg.capacity(x.shape[1]) >= x.shape[1]:  # nothing can drop
        assert drops == 0

    tprobs = torch.softmax(torch.einsum(
        "bld,de->ble", torch.from_numpy(x), tp["router"]), -1)
    r = tmoe.dispatch(tprobs, cfg, cfg.capacity(x.shape[1]))
    assert np.array_equal(r.expert.numpy(), top_e)
    assert np.array_equal(r.rank.numpy(), rank)
    assert np.array_equal(r.keep.numpy(), keep)
    assert np.array_equal(r.dispatch_idx.numpy(), idx)
    np.testing.assert_allclose(_combine_w(r, cfg).numpy(), comb, rtol=0,
                               atol=1e-6)

    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    with tmoe.count_drops() as counted:
        ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x), cfg)
    _close(ty, jy, 2e-6)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    assert [(int(n), a) for n, a in counted] == [(drops, keep.size)]


def test_route_breaks_ties_to_the_lower_expert_id():
    """Equal probabilities (exact ties, several at the k-th place) pick the
    lower expert id first, as ``lax.top_k``."""
    p = np.array([[0.1, 0.3, 0.3, 0.1, 0.1, 0.1],
                  [0.2, 0.2, 0.2, 0.2, 0.1, 0.1],
                  [0.0, 0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    for k in (1, 2, 3):
        jv, je = jax.lax.top_k(jnp.asarray(p), k)
        tv, te = tmoe.route(torch.from_numpy(p), k)
        assert np.array_equal(te.numpy(), np.asarray(je))
        want = np.asarray(jv) / np.asarray(jv).sum(-1, keepdims=True)
        np.testing.assert_allclose(tv.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("n_experts,s", [(4, 40), (40, 512)])
def test_rank_within_expert_matches_reference(n_experts, s):
    ids = np.random.default_rng(n_experts).integers(
        0, n_experts, (3, s)).astype(np.int32)
    want = jax.vmap(lambda e: jmoe._rank_within_expert(e, n_experts))(
        jnp.asarray(ids))
    got = tmoe.rank_within_expert(torch.from_numpy(ids).long(), n_experts)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["drops_padded", "nodrops_unpadded_shared",
                                  "kimi_pattern_drops"])
def test_apply_moe_gradients_match_reference(name):
    jcfg, cfg = _cfgs(*CASES[name])
    jp, tp = _params(jcfg, seed=2)
    x = _x(2, 16, seed=3)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.apply_moe(p, xx, jcfg)
        return jnp.sum(y * w) + 10.0 * aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    flat, names = [], []
    for k in sorted(leaves):
        if isinstance(leaves[k], dict):
            for kk in sorted(leaves[k]):
                flat.append(leaves[k][kk])
                names.append((k, kk))
        else:
            flat.append(leaves[k])
            names.append((k,))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.apply_moe(leaves, xt, cfg)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum() + 10.0 * aux,
                              flat + [xt])
    for g, key in zip(got[:-1], names):
        want = jg_p
        for part in key:
            want = want[part]
        _close(g, want, 1e-5)
    _close(got[-1], jg_x, 1e-5)


@pytest.mark.parametrize("name", ["nodrops_padded", "drops_unpadded_shared",
                                  "granite_pattern"])
def test_apply_moe_bf16_matches_reference(name):
    """bf16 weights and input on both sides (the router f32): the routing
    from the same bf16 input equals the reference's and the outputs lie
    within the bf16 tolerance."""
    jcfg, cfg = _cfgs(*CASES[name])
    jp, tp = _params(jcfg, seed=5, dtype=jnp.bfloat16)
    assert tp["w_gate"].dtype == torch.bfloat16
    assert tp["router"].dtype == torch.float32
    x = _x(2, 24, seed=6)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    _, _, keep, idx, _, _ = _reference_routing(
        jp, np.asarray(xb, np.float32), jcfg)
    r = tmoe.dispatch(torch.softmax(torch.einsum(
        "bld,de->ble", xt.float(), tp["router"]), -1), cfg,
        cfg.capacity(x.shape[1]))
    assert np.array_equal(r.dispatch_idx.numpy(), idx)
    assert np.array_equal(r.keep.numpy(), keep)
    jy, jaux = jmoe.apply_moe(jp, xb, jcfg)
    ty, taux = tmoe.apply_moe(tp, xt, cfg)
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    _close(ty, jy, 3e-2)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)


def test_init_moe_has_the_reference_layout():
    for shared in (0, 1):
        jcfg, cfg = _cfgs(40, 8, 1.25, 16, shared)
        jp = jmoe.init_moe(jax.random.PRNGKey(0), D, jcfg,
                           dtype=jnp.bfloat16)
        tp = tmoe.init_moe(torch.Generator().manual_seed(0), D, cfg,
                           dtype=torch.bfloat16)
        want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
        got = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).split(".")[1]), tp)
        assert got == want
        assert cfg.n_experts_padded == jcfg.n_experts_padded == 48
