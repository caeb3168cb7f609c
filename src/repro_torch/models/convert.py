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
    (nested dicts of arrays; each layer leaf stacked on ``n_periods``)."""
    model = init_model(cfg, device=device)
    _put(model.embed, tree["embed"], "embed")
    for k, v in tree["final_norm"].items():
        _put(model.final_norm[k], v, f"final_norm.{k}")
    for i in range(len(cfg.period)):
        pos = tree["layers"][f"pos{i}"]
        for pi, period in enumerate(model.layers):
            blk = period[f"pos{i}"]
            for norm in ("norm1", "norm2"):
                for k, v in pos[norm].items():
                    _put(getattr(blk, norm)[k], np.asarray(v)[pi],
                         f"layers.pos{i}.{norm}.{k}[{pi}]")
            for k, v in pos["mamba"].items():
                _put(getattr(blk.mamba, k), np.asarray(v)[pi],
                     f"layers.pos{i}.mamba.{k}[{pi}]")
    return model
