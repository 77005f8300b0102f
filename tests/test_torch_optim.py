"""The port's AdamW, Adafactor, SGD with momentum and schedules against
the JAX package's (``repro.optim.optimizers``).

The same numpy parameters and per-step gradients go to both sides for
five steps, with weight decay, global-norm clipping and a warm-up cosine
schedule (AdamW), factored and unfactored leaves, update clipping and
weight decay (Adafactor), and momentum (SGD). Parameters and optimizer
state agree within ``1e-6`` relative to each tensor's magnitude: both
sides run the same f32 arithmetic, in another order only inside the
global norm and Adafactor's means. Each optimizer's in-place guarded
update (``guarded_in_place``) holds the functional update's values bit
for bit and keeps every leaf where the guard skips the step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import sasrec as jax_sasrec
from repro.optim import optimizers as jopt
from repro_torch.models.convert import (
    adamw_state_from_jax,
    sasrec_params_from_jax,
)
from repro_torch.optim import optimizers as opt


def _tree(rng):
    return {
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "layers": {"b": rng.standard_normal((2, 5)).astype(np.float32),
                   "g": (1 + 0.1 * rng.standard_normal(7)).astype(np.float32)},
    }


def _to_torch(tree):
    return opt.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                        tree)


def _assert_tree_close(got, want, rel=1e-6):
    flat_g, flat_w = opt.tree_leaves(got), jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("step", [0, 1, 3, 4, 10, 40])
def test_schedules_match_reference(step):
    for got_fn, want_fn in (
        (opt.cosine_schedule(1e-3, 30), jopt.cosine_schedule(1e-3, 30)),
        (opt.linear_warmup_cosine(1e-3, 4, 30),
         jopt.linear_warmup_cosine(1e-3, 4, 30)),
    ):
        got = got_fn(torch.tensor(step, dtype=torch.int32)).item()
        want = float(want_fn(jnp.asarray(step, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("kw", [
    dict(weight_decay=0.01, clip_norm=0.5, schedule=True),
    dict(weight_decay=0.0, clip_norm=None, schedule=False),
])
def test_adamw_steps_match_reference(kw):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    lr = 1e-2
    if kw["schedule"]:
        t_lr, j_lr = (opt.linear_warmup_cosine(lr, 2, 5),
                      jopt.linear_warmup_cosine(lr, 2, 5))
    else:
        t_lr = j_lr = lr
    t_init, t_update = opt.adamw(t_lr, weight_decay=kw["weight_decay"],
                                 clip_norm=kw["clip_norm"])
    j_init, j_update = jopt.adamw(j_lr, weight_decay=kw["weight_decay"],
                                  clip_norm=kw["clip_norm"])
    tp, jp = _to_torch(params), jax.tree.map(jnp.asarray, params)
    ts, js = t_init(tp), j_init(jp)
    for _ in range(5):
        grads = _tree(rng)
        tp, ts = t_update(_to_torch(grads), ts, tp)
        jp, js = j_update(jax.tree.map(jnp.asarray, grads), js, jp)
        _assert_tree_close(tp, jp)
        _assert_tree_close(ts.inner["m"], js.inner["m"])
        _assert_tree_close(ts.inner["v"], js.inner["v"])
        assert int(ts.step) == int(js.step)
        assert ts.step.dtype == torch.int32


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(1)
    g = _tree(rng)
    got = opt.global_norm(_to_torch(g)).item()
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, g)))
    assert got == pytest.approx(want, rel=1e-6)
    clipped, norm = opt.clip_by_global_norm(_to_torch(g), 0.5)
    jclipped, _ = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    _assert_tree_close(clipped, jclipped)
    assert opt.global_norm(clipped).item() == pytest.approx(0.5, rel=1e-5)


def test_make_optimizer_names():
    init, _ = opt.make_optimizer("adamw", 1e-3)
    state = init({"a": torch.zeros(2, dtype=torch.float64)})
    assert state.inner["m"]["a"].dtype == torch.float32
    init, _ = opt.make_optimizer("adafactor", 1e-3)
    state = init({"a": torch.zeros(2, dtype=torch.bfloat16),
                  "w": torch.zeros(3, 128, 130, dtype=torch.bfloat16)})
    assert state.inner["v"]["a"]["v"].dtype == torch.float32
    assert state.inner["v"]["w"]["vr"].shape == (3, 128)
    assert state.inner["v"]["w"]["vc"].shape == (3, 130)
    init, _ = opt.make_optimizer("sgd", 1e-3, momentum=0.5)
    assert init({"a": torch.zeros(2)}).inner["m"]["a"].dtype == torch.float32
    with pytest.raises(KeyError):
        opt.make_optimizer("lion", 1e-3)


def _big_tree(rng):
    """Leaves Adafactor factors (last two axes ≥ 128, stacked or not) and
    leaves it keeps whole."""
    return {
        "emb": rng.standard_normal((130, 128)).astype(np.float32),
        "layers": {"w": rng.standard_normal((2, 128, 160)).astype(np.float32),
                   "narrow": rng.standard_normal((2, 128, 8))
                   .astype(np.float32) * 3,
                   "g": (1 + 0.1 * rng.standard_normal(7))
                   .astype(np.float32)},
    }


@pytest.mark.parametrize("name,kw", [
    ("adafactor", dict()),
    ("adafactor", dict(weight_decay=0.01, clip_threshold=0.05,
                       decay=0.6)),
    ("sgd", dict()),
    ("sgd", dict(momentum=0.5)),
])
def test_adafactor_and_sgd_steps_match_reference(name, kw):
    """Five updates, each with fresh gradients, at a warm-up cosine
    schedule: parameters and state within 1e-6 of their magnitude of the
    reference's (``clip_threshold`` 0.05 makes the update clipping bite
    on every leaf)."""
    rng = np.random.default_rng(5)
    params = _big_tree(rng)
    t_lr, j_lr = (opt.linear_warmup_cosine(1e-2, 2, 5),
                  jopt.linear_warmup_cosine(1e-2, 2, 5))
    t_init, t_update = opt.make_optimizer(name, t_lr, **kw)
    j_init, j_update = jopt.make_optimizer(name, j_lr, **kw)
    tp, jp = _to_torch(params), jax.tree.map(jnp.asarray, params)
    ts, js = t_init(tp), j_init(jp)
    key = "v" if name == "adafactor" else "m"
    for _ in range(5):
        grads = _big_tree(rng)
        tp, ts = t_update(_to_torch(grads), ts, tp)
        jp, js = j_update(jax.tree.map(jnp.asarray, grads), js, jp)
        _assert_tree_close(tp, jp)
        _assert_tree_close(ts.inner[key], js.inner[key])
        assert int(ts.step) == int(js.step)
    if name == "adafactor":
        assert set(ts.inner["v"]["emb"]) == {"vr", "vc"}
        assert set(ts.inner["v"]["layers"]["narrow"]) == {"v"}


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_guarded_in_place_equals_the_functional_update(name, monkeypatch):
    """Two guarded in-place updates hold the functional update's values
    bit for bit (AdamW and SGD with every leaf cut into slices along its
    first axis), and a skipped third keeps every leaf bit for bit."""
    monkeypatch.setattr(opt, "SLICE_ELEMS", 128 * 40)
    rng = np.random.default_rng(6)
    p0 = _to_torch(_big_tree(rng))
    grads = _to_torch(_big_tree(rng))
    init, update = opt.make_optimizer(name, 1e-2)
    pf = opt.tree_map(torch.clone, p0)
    sf = init(pf)
    p = opt.tree_map(torch.clone, p0)
    s = init(p)
    for _ in range(2):
        pf, sf = update(grads, sf, pf)
        p, s = update.guarded_in_place(grads, s, p, torch.tensor(True))
    leaves = opt.tree_leaves(p) + opt.tree_leaves(s)
    assert all(torch.equal(a, b) for a, b in
               zip(leaves, opt.tree_leaves(pf) + opt.tree_leaves(sf)))
    before = [t.clone() for t in leaves]
    p, s = update.guarded_in_place(grads, s, p, torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in
               zip(opt.tree_leaves(p) + opt.tree_leaves(s), before))


def test_adafactor_state_from_jax_round_trips():
    """A reference Adafactor state after one step carries across leaf for
    leaf and steps on like the reference."""
    from repro_torch.models.convert import adafactor_state_from_jax

    rng = np.random.default_rng(7)
    params = _big_tree(rng)
    j_init, j_update = jopt.adafactor(1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    g1, g2 = (jax.tree.map(jnp.asarray, _big_tree(rng)) for _ in range(2))
    jp1, js1 = j_update(g1, j_init(jp), jp)
    state = adafactor_state_from_jax(jax.tree.map(np.asarray, js1),
                                     device="cpu")
    assert state.step.dtype == torch.int32 and int(state.step) == 1
    for got, want in zip(opt.tree_leaves(state.inner["v"]),
                         jax.tree.leaves(js1.inner["v"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, t_update = opt.adafactor(1e-3)
    tp2, ts2 = t_update(_to_torch(jax.tree.map(np.asarray, g2)), state,
                        _to_torch(jax.tree.map(np.asarray, jp1)))
    jp2, js2 = j_update(g2, js1, jp1)
    _assert_tree_close(tp2, jp2)
    _assert_tree_close(ts2.inner["v"], js2.inner["v"])
    with pytest.raises(KeyError):
        adafactor_state_from_jax((js1.step, {"m": js1.inner["v"]}),
                                 device="cpu")


def test_adamw_state_from_jax_round_trips():
    """A reference AdamW state after one step of a SASRec model carries
    across as a copy, leaf for leaf, and steps on like the reference."""
    jcfg = jax_get_arch("sasrec-sce").make_smoke_config()
    jp = jax_sasrec.init_params(jax.random.PRNGKey(0), jcfg)
    j_init, j_update = jopt.adamw(1e-3, weight_decay=0.01)
    j_update = jax.jit(j_update)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), jp)
    jp1, js1 = j_update(grads, j_init(jp), jp)
    state = adamw_state_from_jax(jax.tree.map(np.asarray, js1), device="cpu")
    assert state.step.dtype == torch.int32 and int(state.step) == 1
    for k in ("m", "v"):
        for got, want in zip(opt.tree_leaves(state.inner[k]),
                             jax.tree.leaves(js1.inner[k])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    params = sasrec_params_from_jax(jax.tree.map(np.asarray, jp1),
                                    device="cpu")
    _, t_update = opt.adamw(1e-3, weight_decay=0.01)
    tp2, ts2 = t_update(opt.tree_map(lambda g: torch.from_numpy(
        np.array(g)), jax.tree.map(np.asarray, grads)), state, params)
    jp2, js2 = j_update(grads, js1, jp1)
    _assert_tree_close(tp2, jp2)
    _assert_tree_close(ts2.inner["v"], js2.inner["v"])
    with pytest.raises(KeyError):
        adamw_state_from_jax((js1.step, {"m": js1.inner["m"]}), device="cpu")
