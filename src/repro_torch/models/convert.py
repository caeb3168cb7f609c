"""Carry model parameters between the port's layout and the JAX package's.

The two packages draw initial weights from different generators, so a
comparison of the two computes from one set of weights: the JAX package's
``init_model`` tree, as numpy arrays, copied into a :class:`Model`
(:func:`params_from_jax`). :func:`jax_tree` goes the other way; the
checkpoint manager writes it, so that a checkpoint of either package
restores in the other.

The port names a parameter by its module path (``layers.3.pos0.attn.wq``,
``enc_layers.1.mlp.w_up``, ``final_norm.scale``); the reference's tree
holds it at ``layers/pos0/attn/wq`` stacked on a leading ``n_periods``
axis (``enc_layers`` on an ``enc_layers`` axis).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, init_model

STACKED = ("layers", "enc_layers")


def jax_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """A port parameter name's path in the reference's tree, and its index
    on the stacked axis (None for an unstacked leaf)."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def jax_tree(named: Mapping[str, torch.Tensor]) -> Dict:
    """Tensors (or numpy arrays) keyed by port parameter names
    (``named_parameters()``, or optimizer moments keyed like them) as the
    reference's nested dict, each stacked leaf a new tensor (array)."""
    tree: Dict = {}
    stacks: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        path, idx = jax_path(name)
        if idx is None:
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = t
        else:
            stacks.setdefault(path, {})[idx] = t
    for path, by_idx in stacks.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        parts = [by_idx[i] for i in range(len(by_idx))]
        node[path[-1]] = (torch.stack(parts) if torch.is_tensor(parts[0])
                          else np.stack(parts))
    return tree


def leaf_of(tree: Mapping, name: str):
    """The reference tree's value for a port parameter name (its slice on
    the stacked axis)."""
    path, idx = jax_path(name)
    node = tree
    for p in path:
        node = node[p]
    return node if idx is None else node[idx]


def _put(param: torch.Tensor, arr, name: str) -> None:
    arr = np.asarray(arr, dtype=np.float32)  # bf16 -> f32 -> bf16 is exact
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {arr.shape} != {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.tensor(arr).to(param.dtype))


def params_from_jax(tree, cfg: ModelConfig, device="cpu") -> Model:
    """The port's parameters from the JAX package's ``init_model`` tree
    (nested dicts of arrays; each layer leaf stacked): every parameter of
    the port's :class:`Model` from the leaf at its path, the embedding,
    the norms, attention, cross-attention, Mamba-2, MLP and MoE layers,
    the encoder stack and the patch projection."""
    model = init_model(cfg, device=device)
    for name, param in model.named_parameters():
        _put(param, np.asarray(leaf_of(tree, name)), name)
    return model
