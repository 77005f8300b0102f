"""The port's loss registry against the JAX package's (``core/losses.py``).

Every registry name runs on the same numpy inputs on both sides, under a
``valid_mask`` with padded positions, and the loss, the aux values and
the gradients in ``x`` and ``y`` are compared. The frameworks cannot
share random bits, so each draw is made once by the reference's own code
from its key and handed to the port's draw helper (monkeypatched): the
uniform negatives (``_sample_negatives``), the popularity uniforms
(``jax.random.uniform`` up to the CDF's total), RECE's hyperplanes
(``jax.random.normal``) and SCE's Mix Ω (``omega=``). ``ce_fused`` and
``ce_fused_linear`` reach the JAX kernels in Pallas interpret mode (the
kernel guard off, as the reference's own tests run them on the CPU).

Tolerances: f32 sums in another fold order, scaled to the tensor: the
loss and aux within ``1e-5`` relative; gradients within
``1e-5·max|grad|`` plus ``2e-4·|grad|``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro.core.sce import SCEConfig as JaxSCEConfig
from repro.kernels import guard
from repro_torch.core import losses
from repro_torch.core.sce import SCEConfig

N, C, D = 48, 300, 12
POPULARITY = np.random.default_rng(7).integers(0, 50, C).astype(np.float32)
SCE_CFG = dict(n_buckets=8, bucket_size_x=16, bucket_size_y=32,
               use_mix=True, use_kernel=False)

CASES = [  # (registry name, make_loss kwargs)
    ("ce", {}),
    ("ce_chunked", {}),
    ("ce_chunked", {"chunk_size": 64, "logit_softcap": 30.0}),
    ("ce_fused", {}),
    ("ce_fused_linear", {}),
    ("ce_fused_linear", {"logit_softcap": 30.0, "block_c": 64}),
    ("bce", {}),
    ("bce_plus", {"num_negatives": 8}),
    ("gbce", {"num_negatives": 8, "t": 0.75}),
    ("ce_minus", {"num_negatives": 16}),
    ("ce_inbatch", {}),
    ("ce_pop", {"num_negatives": 8}),
    ("ce_pop", {"num_negatives": 8, "popularity": POPULARITY}),
    ("rece", {"n_hashes": 6, "n_chunks": 4}),
    ("sce", {"cfg": SCE_CFG}),
]


@pytest.fixture(autouse=True)
def _guard_off():
    guard.set_policy("off")
    yield
    guard.set_policy(None)


def _problem(seed):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((N, D))).astype(np.float32)
    y = rng.standard_normal((C, D)).astype(np.float32)
    t = rng.integers(0, C, N).astype(np.int32)
    t[:6] = t[6]  # a target shared by several positions
    valid = rng.random(N) > 0.2
    return x, y, t, valid


def _kwargs(kw, side):
    """The case's kwargs for one side: the popularity as that side's
    array, the SCE config as that side's dataclass."""
    out = dict(kw)
    if "popularity" in out:
        out["popularity"] = (jnp.asarray(out["popularity"]) if side == "jax"
                             else torch.from_numpy(out["popularity"]))
    if "cfg" in out:
        out["cfg"] = (JaxSCEConfig if side == "jax" else SCEConfig)(
            **out["cfg"])
    return out


def _inject_draws(monkeypatch, name, kw, key):
    """The reference's draw for this case, made by its own code from
    ``key``, patched into the port's draw helper; returns the extra kwargs
    the port's call needs (SCE's Ω)."""
    k = kw.get("num_negatives", 1)
    if name in ("bce", "bce_plus", "gbce", "ce_minus") or (
            name == "ce_pop" and "popularity" not in kw):
        draw = np.array(jlosses._sample_negatives(key, N, k, C))
        monkeypatch.setattr(losses, "_sample_negatives",
                            lambda *a: torch.from_numpy(draw))
    elif name == "ce_pop":
        cdf = jnp.cumsum(jnp.maximum(jnp.asarray(kw["popularity"]), 0.0))
        u = np.array(jax.random.uniform(key, (N, k), maxval=cdf[-1]))
        monkeypatch.setattr(losses, "_popularity_uniforms",
                            lambda *a: torch.from_numpy(u))
    elif name == "rece":
        planes = np.array(jax.random.normal(key, (D, kw["n_hashes"])))
        monkeypatch.setattr(losses, "_rece_planes",
                            lambda *a: torch.from_numpy(planes))
    elif name == "sce":
        omega = np.array(jax.random.normal(
            key, (kw["cfg"]["n_buckets"], N), jnp.float32))
        return {"omega": torch.from_numpy(omega)}
    return {}


def _close(got, want, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err <= 1e-5 * np.abs(want).max() + rtol * np.abs(want)).all(), \
        err.max()


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_registry_loss_matches_reference(monkeypatch, name, kw):
    x, y, t, valid = _problem(3)
    key = jax.random.PRNGKey(11)
    extra = _inject_draws(monkeypatch, name, kw, key)

    jfn = jlosses.make_loss(name, **_kwargs(kw, "jax"))
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda a, b: jfn(a, b, jnp.asarray(t), valid_mask=jnp.asarray(valid),
                         key=key), argnums=(0, 1), has_aux=True,
    )(jnp.asarray(x), jnp.asarray(y))

    fn = losses.make_loss(name, **_kwargs(kw, "torch"))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, y)]
    loss, aux = fn(*leaves, torch.from_numpy(t),
                   valid_mask=torch.from_numpy(valid),
                   generator=torch.Generator().manual_seed(0), **extra)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)

    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    jaux = {k: v for k, v in jaux.items() if k != "sentinels"}
    assert set(aux) == set(jaux)
    for k in aux:
        assert float(aux[k].detach()) == pytest.approx(float(jaux[k]),
                                                       rel=1e-5), k
    for g, jg in zip(grads, jgrads):
        g = np.zeros(jg.shape, np.float32) if g is None else g.numpy()
        _close(g, np.asarray(jg), rtol=2e-4)


def test_sampled_losses_draw_from_the_generator():
    """Without injection the negatives come from the generator: the same
    seed gives the same loss, and no generator is an error."""
    x, y, t, valid = map(torch.from_numpy, _problem(4))
    for name in ("bce", "gbce", "ce_minus", "ce_pop", "rece"):
        fn = losses.make_loss(name)
        a, _ = fn(x, y, t, valid, torch.Generator().manual_seed(5))
        b, _ = fn(x, y, t, valid, torch.Generator().manual_seed(5))
        assert torch.equal(a, b) and torch.isfinite(a)
        with pytest.raises(ValueError, match="Generator"):
            fn(x, y, t, valid)


@pytest.mark.parametrize("n_hashes", [1, 8, 31, 32])
def test_lsh_codes_match_reference(n_hashes):
    """The codes equal the reference's uint32 ones, bit 31 included."""
    rng = np.random.default_rng(n_hashes)
    v = rng.standard_normal((64, 16)).astype(np.float32)
    planes = rng.standard_normal((16, n_hashes)).astype(np.float32)
    want = np.asarray(jlosses.lsh_codes(jnp.asarray(v), jnp.asarray(planes)))
    got = losses.lsh_codes(torch.from_numpy(v), torch.from_numpy(planes))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_lsh_codes_and_rece_reject_more_than_32_hashes():
    v = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="32"):
        losses.lsh_codes(v, torch.zeros(8, 33))
    x, y, t, _ = map(torch.from_numpy, _problem(5))
    with pytest.raises(ValueError, match=r"\[1, 32\]"):
        losses.rece(x, y, t, generator=torch.Generator(), n_hashes=33)


def test_make_loss_raises_on_unknown_name():
    with pytest.raises(KeyError, match="unknown loss"):
        losses.make_loss("no_such_loss")
    assert sorted(losses._REGISTRY) == sorted(jlosses._REGISTRY)


def test_loss_peak_elements_matches_reference():
    """Every registry name on a grid of shapes and kwargs."""
    kwargs = [{}, {"num_negatives": 64}, {"chunk_size": 1024},
              {"n_chunks": 4}, {"block_n": 64, "block_c": 128},
              {"t": 0.5, "logit_softcap": 30.0, "n_hashes": 8}]
    for n, c, d in ((25_600, 173_520, 64), (4_096, 1_000_000, 128),
                    (48, 300, 12)):
        jcfg = JaxSCEConfig.from_alpha_beta(n, c, use_kernel=True)
        cfg = SCEConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(jcfg)})
        for name in sorted(jlosses._REGISTRY):
            for kw in kwargs:
                want = jlosses.loss_peak_elements(name, n, c, d, cfg=jcfg,
                                                  **kw)
                got = losses.loss_peak_elements(name, n, c, d, cfg=cfg, **kw)
                assert got == want, (name, kw)
    with pytest.raises(KeyError):
        losses.loss_peak_elements("no_such_loss", 8, 8, 8)
