"""Train step: loss + grad (with microbatch accumulation) + AdamW update.

The PyTorch counterpart of the JAX package's ``train/train_step.py``.
Gradient accumulation is a loop over microbatches with float32
accumulators, ``a + g.float() / accum`` as in the reference, cast back to
each parameter's dtype before the update. Gradients come from autograd
(``torch.autograd.grad``); a parameter the loss does not reach (a norm
of a position without an MLP) gets a zero gradient, as ``jax.grad``
gives it. The step takes DTensors too (parameters and moments placed on
a mesh, and the batch's rows; see :mod:`repro_torch.train.sharding`):
run it under that module's ``mesh_axes``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import model as MDL
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, tokens, targets, frontend_embeds=None):
        total, (loss, aux) = MDL.lm_loss(params, tokens, targets, cfg,
                                         frontend_embeds=frontend_embeds)
        return total, {"loss": loss, "aux": aux}

    return loss_fn


def _grads(total, named):
    gs = torch.autograd.grad(total, [p for _, p in named], allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(named, gs)}


def _split(x, accum: int):
    """``accum`` microbatches of rows: consecutive blocks of the batch, or
    of each rank's own rows for a DTensor batch (a microbatch is then
    every rank's i-th block, and no row moves)."""
    if not isinstance(x, DTensor):
        return x.reshape(accum, x.shape[0] // accum, *x.shape[1:])
    local = x.to_local()
    local = local.reshape(accum, local.shape[0] // accum, *local.shape[1:])
    shape = (x.shape[0] // accum,) + tuple(x.shape[1:])
    return [DTensor.from_local(m, x.device_mesh, x.placements,
                               run_check=False, shape=shape,
                               stride=m.stride()) for m in local]


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                    accum: int = 1):
    """Returns train_step(params, opt_state, tokens, targets[, frontend])
    -> (params, opt_state, metrics), the parameters updated in place.

    tokens/targets: (global_batch, S); frontend: (global_batch, P, d) or
    None. metrics: the loss, the aux loss, ``grad_norm``, ``lr`` and
    ``total_loss`` (each a scalar tensor; over microbatches, their mean).
    """
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state, tokens, targets,
                   frontend: Optional[torch.Tensor] = None):
        named = list(params.named_parameters())
        if accum == 1:
            total, metrics = loss_fn(params, tokens, targets, frontend)
            grads = _grads(total, named)
        else:
            toks, tgts = _split(tokens, accum), _split(targets, accum)
            fes = _split(frontend, accum) if frontend is not None else None
            g_acc = {n: torch.zeros_like(p, dtype=torch.float32).detach()
                     for n, p in named}
            total, ms = 0.0, []
            for i in range(accum):
                t, m = loss_fn(params, toks[i], tgts[i],
                               None if fes is None else fes[i])
                for n, g in _grads(t, named).items():
                    g_acc[n] = g_acc[n] + g.float() / accum
                total = total + t.detach() / accum
                ms.append(m)
            grads = {n: g_acc[n].to(p.dtype) for n, p in named}
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, opt_metrics = adamw.update(grads, opt_state,
                                                      params, opt_cfg)
        metrics = dict(metrics, **opt_metrics, total_loss=total.detach())
        return params, opt_state, metrics

    return train_step


def init_state(cfg: ModelConfig, opt_cfg: adamw.OptConfig, seed: int = 0,
               device=None):
    """A model from ``seed`` with its gradients turned on, and a zero
    optimizer state."""
    params = MDL.init_model(cfg, seed=seed, device=device)
    params.requires_grad_(True)
    return params, adamw.init(params, opt_cfg)
