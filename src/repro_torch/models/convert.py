"""Carry SASRec, transformer-LM (the MoE LMs' included), CTR-model and
SchNet weights and their AdamW or Adafactor state across from the JAX
package.

The port keeps the reference's parameter layout, so conversion is a
copy: each numpy leaf of the JAX pytree becomes a tensor of the same
shape, with no transpose anywhere.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim.optimizers import OptState

TOP_KEYS = ("item_emb", "pos_emb", "ln_f_g", "ln_f_b", "layers")
LAYER_KEYS = (
    "wqkv", "wo", "w1", "w2", "b1", "b2", "ln1_g", "ln1_b", "ln2_g", "ln2_b",
)


def _tensor(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor of its type; a bfloat16 leaf (numpy's
    ``ml_dtypes`` type, which torch cannot read) through its exact f32
    values."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def sasrec_params_from_jax(tree: Mapping, *, device=None):
    """The port's SASRec parameters from a JAX SASRec pytree whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, params)``).

    Expected keys: ``item_emb`` (rows, d), ``pos_emb`` (max_len, d),
    ``ln_f_g``/``ln_f_b`` (d,), and ``layers`` with ``wqkv``, ``wo``,
    ``w1``, ``w2`` stacked ``(n_layers, d_in, d_out)`` and ``b1``,
    ``b2``, ``ln{1,2}_{g,b}`` stacked ``(n_layers, width)``. Raises
    ``KeyError`` on a missing or unexpected key. The tensors land on
    ``device``: ``cuda`` unless given (raises without CUDA).
    """
    device = resolve_device(device)
    if set(tree) != set(TOP_KEYS):
        raise KeyError(f"expected keys {TOP_KEYS}, got {sorted(tree)}")
    layers = tree["layers"]
    if set(layers) != set(LAYER_KEYS):
        raise KeyError(f"expected layer keys {LAYER_KEYS}, got {sorted(layers)}")
    out = {k: _tensor(tree[k], device) for k in TOP_KEYS if k != "layers"}
    out["layers"] = {k: _tensor(layers[k], device) for k in LAYER_KEYS}
    return out


TRANSFORMER_LAYER_KEYS = ("wq", "wk", "wv", "wo", "norm_attn", "norm_mlp")
TRANSFORMER_FFN_KEYS = ("mlp", "moe")  # one of them: dense or MoE
TRANSFORMER_POST_NORMS = ("norm_attn_post", "norm_mlp_post")
MLP_KEYS = ("w_gate", "w_up", "w_down")
MOE_KEYS = ("router",) + MLP_KEYS
MOE_SHARED = "shared"


def _tree(tree, device):
    """Nested dicts and lists of numpy leaves → the same dicts and lists
    of tensors."""
    if isinstance(tree, Mapping):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device) for v in tree]
    return _tensor(tree, device)


def transformer_params_from_jax(tree: Mapping, *, device=None):
    """The port's transformer-LM parameters from a JAX pytree of
    ``repro.models.transformer.init_params``' layout, its leaves numpy
    arrays: ``embed`` (V_pad, d), ``norm_final`` (d,), ``unembed`` when
    the embeddings are untied, and ``layers`` stacked ``(n_layers, …)``:
    ``wq``, ``wk``, ``wv``, ``wo``, ``norm_attn``, ``norm_mlp``, the
    post-block norms when present, and either ``mlp`` with ``w_gate``,
    ``w_up`` and ``w_down`` or, for an MoE model, ``moe`` with
    ``router``, the experts' ``w_gate``, ``w_up``, ``w_down`` and
    optionally ``shared`` (the shared experts' three). Raises
    ``KeyError`` on a missing or unexpected key. The tensors land on
    ``device``: ``cuda`` unless given (raises without CUDA)."""
    device = resolve_device(device)
    top = set(tree) - {"unembed"}
    if top != {"embed", "norm_final", "layers"}:
        raise KeyError(f"expected keys embed, norm_final, layers "
                       f"[, unembed], got {sorted(tree)}")
    layers = tree["layers"]
    ffn = set(layers) & set(TRANSFORMER_FFN_KEYS)
    extra = set(layers) - set(TRANSFORMER_LAYER_KEYS) - ffn
    if not set(TRANSFORMER_LAYER_KEYS) <= set(layers) or len(ffn) != 1 \
            or extra not in (set(), set(TRANSFORMER_POST_NORMS)):
        raise KeyError(f"expected layer keys {TRANSFORMER_LAYER_KEYS}, one "
                       f"of {TRANSFORMER_FFN_KEYS} [+ "
                       f"{TRANSFORMER_POST_NORMS}], got {sorted(layers)}")
    if "mlp" in layers and set(layers["mlp"]) != set(MLP_KEYS):
        raise KeyError(f"expected mlp keys {MLP_KEYS}, got "
                       f"{sorted(layers['mlp'])}")
    if "moe" in layers:
        moe = layers["moe"]
        if set(moe) - {MOE_SHARED} != set(MOE_KEYS) or (
                MOE_SHARED in moe and set(moe[MOE_SHARED]) != set(MLP_KEYS)):
            raise KeyError(f"expected moe keys {MOE_KEYS} [+ {MOE_SHARED}: "
                           f"{MLP_KEYS}], got {sorted(moe)}")
    return _tree(tree, device)


# The CTR models' top-level layouts (``models/recsys.py``): DCN-v2, DLRM,
# xDeepFM. Lists hold one table a field or one weight a layer; MLPs are
# dicts of ``w{i}`` / ``b{i}``.
RECSYS_LAYOUTS = (
    ("tables", "cross_w", "cross_b", "deep", "head_w", "head_b"),
    ("tables", "bot", "top"),
    ("tables", "linear", "cin_w", "cin_head", "dnn", "bias"),
)
RECSYS_LISTS = ("tables", "cross_w", "cross_b", "linear", "cin_w")
RECSYS_MLPS = ("deep", "bot", "top", "dnn")


def recsys_params_from_jax(tree: Mapping, *, device=None):
    """The port's DCN-v2, DLRM or xDeepFM parameters from a JAX pytree of
    ``repro.models.recsys``' layout, its leaves numpy arrays: the
    ``tables``, ``linear``, ``cin_w``, ``cross_w`` and ``cross_b`` lists
    stay lists, each MLP a dict of ``w{i}`` / ``b{i}``. Raises
    ``KeyError`` on a layout that is none of the three. The tensors land
    on ``device``: ``cuda`` unless given (raises without CUDA)."""
    device = resolve_device(device)
    if not any(set(tree) == set(lay) for lay in RECSYS_LAYOUTS):
        raise KeyError(f"expected one of the layouts {RECSYS_LAYOUTS}, got "
                       f"{sorted(tree)}")
    for k in set(tree) & set(RECSYS_LISTS):
        if not isinstance(tree[k], (list, tuple)):
            raise KeyError(f"{k!r} is not a list")
    for k in set(tree) & set(RECSYS_MLPS):
        n = len(tree[k]) // 2
        if set(tree[k]) != {f"{c}{i}" for c in "wb" for i in range(n)}:
            raise KeyError(f"expected MLP keys w0..w{n - 1}, b0..b{n - 1} "
                           f"in {k!r}, got {sorted(tree[k])}")
    return _tree(tree, device)


SCHNET_KEYS = ("embed", "interactions", "head_w1", "head_b1", "head_w2",
               "head_b2")
SCHNET_INTERACTION_KEYS = ("w_in", "w_filter1", "w_filter2", "w_out1",
                           "b_filter1", "b_filter2", "b_out1")


def schnet_params_from_jax(tree: Mapping, *, device=None):
    """The port's SchNet parameters from a JAX pytree of
    ``repro.models.schnet.init_params``' layout (numpy leaves): ``embed``
    (d_feat, d), the ``interactions`` stacked ``(n_interactions, …)``,
    the head's two layers. Raises ``KeyError`` on a missing or unexpected
    key; the tensors land on ``device`` (``cuda`` unless given)."""
    device = resolve_device(device)
    if set(tree) != set(SCHNET_KEYS):
        raise KeyError(f"expected keys {SCHNET_KEYS}, got {sorted(tree)}")
    if set(tree["interactions"]) != set(SCHNET_INTERACTION_KEYS):
        raise KeyError(f"expected interaction keys "
                       f"{SCHNET_INTERACTION_KEYS}, got "
                       f"{sorted(tree['interactions'])}")
    return _tree(tree, device)


def adamw_state_from_jax(opt_state, *, device=None) -> OptState:
    """The port's AdamW state from the reference's ``OptState(step,
    inner={"m": tree, "v": tree})``, its leaves numpy arrays
    (``jax.tree.map(np.asarray, opt_state)``), for any parameter layout
    (SASRec's, the transformer's, the CTR models' lists): the step becomes a 0-d int32 tensor,
    ``m`` and ``v`` f32 trees of the parameters' nested dicts, on
    ``device`` (``cuda`` unless given; raises without CUDA)."""
    device = resolve_device(device)
    step, inner = opt_state
    if set(inner) != {"m", "v"}:
        raise KeyError(f"expected AdamW moments 'm', 'v', got {sorted(inner)}")
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        inner={k: _tree(inner[k], device) for k in ("m", "v")},
    )


def adafactor_state_from_jax(opt_state, *, device=None) -> OptState:
    """The port's Adafactor state from the reference's ``OptState(step,
    inner={"v": tree})``, its leaves numpy arrays, each parameter's
    entry ``{"vr", "vc"}`` (factored) or ``{"v"}``: the step a 0-d int32
    tensor, the moments f32 trees on ``device`` (``cuda`` unless given;
    raises without CUDA)."""
    device = resolve_device(device)
    step, inner = opt_state
    if set(inner) != {"v"}:
        raise KeyError(f"expected Adafactor moments 'v', got {sorted(inner)}")

    def check(t):
        if not isinstance(t, Mapping):
            raise KeyError("an Adafactor leaf state is not a dict")
        if set(t) in ({"vr", "vc"}, {"v"}):
            return
        for v in t.values():
            check(v)

    check(inner["v"])
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        inner={"v": _tree(inner["v"], device)},
    )
