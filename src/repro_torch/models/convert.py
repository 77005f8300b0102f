"""Carry SASRec weights and their AdamW state across from the JAX
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


def adamw_state_from_jax(opt_state, *, device=None) -> OptState:
    """The port's AdamW state from the reference's ``OptState(step,
    inner={"m": tree, "v": tree})`` of a SASRec model, its leaves numpy
    arrays (``jax.tree.map(np.asarray, opt_state)``): the step becomes a
    0-d int32 tensor, ``m`` and ``v`` f32 trees in the parameters'
    layout, on ``device`` (``cuda`` unless given; raises without CUDA).
    """
    device = resolve_device(device)
    step, inner = opt_state
    if set(inner) != {"m", "v"}:
        raise KeyError(f"expected AdamW moments 'm', 'v', got {sorted(inner)}")
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        inner={k: sasrec_params_from_jax(inner[k], device=device)
               for k in ("m", "v")},
    )
