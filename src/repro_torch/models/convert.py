"""Carry the JAX package's model parameters over to the port.

The two packages draw initial weights from different generators, so a
comparison of the two computes from one set of weights: the JAX package's
``init_model`` tree, as numpy arrays, copied into a :class:`Model`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, init_model


def _put(param: torch.nn.Parameter, arr, name: str) -> None:
    arr = np.asarray(arr, dtype=np.float32)  # bf16 -> f32 -> bf16 is exact
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {arr.shape} != {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.tensor(arr).to(param.dtype))


def params_from_jax(tree, cfg: ModelConfig, device="cpu") -> Model:
    """The port's parameters from the JAX package's ``init_model`` tree
    (nested dicts of arrays; each layer leaf stacked on ``n_periods``):
    the embedding, the untied unembedding, the norms' scales and biases,
    and each position's attention (with its biases), Mamba-2 mixer, MLP
    and MoE layer (router and stacked experts)."""
    model = init_model(cfg, device=device)
    _put(model.embed, tree["embed"], "embed")
    if not cfg.tie_embeddings:
        _put(model.unembed, tree["unembed"], "unembed")
    for k, v in tree["final_norm"].items():
        _put(model.final_norm[k], v, f"final_norm.{k}")
    for i in range(len(cfg.period)):
        pos = tree["layers"][f"pos{i}"]
        for pi, period in enumerate(model.layers):
            blk = period[f"pos{i}"]
            for part, leaves in pos.items():
                mod = getattr(blk, part)
                for k, v in leaves.items():
                    _put(mod[k] if isinstance(mod, torch.nn.ParameterDict)
                         else getattr(mod, k), np.asarray(v)[pi],
                         f"layers.pos{i}.{part}.{k}[{pi}]")
    return model
