"""AdamW with a cosine schedule, global-norm clipping and a dtype policy.

The PyTorch counterpart of the JAX package's ``optim/adamw.py``, with the
reference's arithmetic in the reference's order. The parameters are a
model's named parameters; the moments are tensors keyed by the same
names, in ``moment_dtype`` (bfloat16 for the largest architectures).
:func:`update` writes the new values into the parameters in place (the
reference returns a new tree), which saves a copy of the weights.
Weight decay skips the leaves the reference's ``_decayable`` names: norm
scales and biases, the attention biases, Mamba-2's ``A_log``, ``D``,
``dt_bias``, ``norm_scale`` and convolution biases.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple

import torch

from repro_torch.train import sharding as SH

NO_DECAY = frozenset({
    "scale", "bias", "A_log", "D", "dt_bias", "norm_scale",
    "bq", "bk", "bv", "conv_bx", "conv_bB", "conv_bC",
})


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" for the >100B archs


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine to ``min_lr_frac · lr``;
    float32, as the reference computes it."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + 0.5 * (1 - cfg.min_lr_frac) * cfg.lr * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def decayable(name: str) -> bool:
    """Whether weight decay applies to the parameter of this name (by its
    last component, the reference's leaf key)."""
    return name.rsplit(".", 1)[-1] not in NO_DECAY


def init(params: torch.nn.Module, cfg: OptConfig) -> OptState:
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        cfg.moment_dtype]
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device

    def zeros():  # of each parameter's placements too, when a DTensor
        return {n: torch.zeros_like(p, dtype=dt).detach()
                for n, p in named.items()}

    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=zeros(), v=zeros())


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sums of squares, added leaf by leaf."""
    sq = None
    for g in grads.values():
        s = torch.square(g.float()).sum()
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


@torch.no_grad()
def update(grads: Dict[str, torch.Tensor], state: OptState,
           params: torch.nn.Module, cfg: OptConfig):
    """One AdamW step: returns (params, new state, {"grad_norm", "lr"}).
    ``grads`` are keyed by parameter name; the parameters are updated in
    place (``params`` is returned for the reference's signature)."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.minimum(SH.like(_f32(1.0).to(gnorm.device), gnorm),
                          cfg.clip_norm / torch.clamp(gnorm, min=1e-9))
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(_f32(b1).to(stepf.device), stepf)
    bc2 = 1 - torch.pow(_f32(b2).to(stepf.device), stepf)
    new_m, new_v = {}, {}
    for name, p in params.named_parameters():
        g, m, v = grads[name], state.m[name], state.v[name]
        gf = g.float() * SH.like(scale, g)
        mf = m.float() * b1 + (1 - b1) * gf
        vf = v.float() * b2 + (1 - b2) * torch.square(gf)
        mhat = mf / SH.like(bc1, mf)
        vhat = vf / SH.like(bc2, vf)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decayable(name):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - SH.like(lr, delta) * delta).to(p.dtype))
        new_m[name] = mf.to(m.dtype)
        new_v[name] = vf.to(v.dtype)
    return params, OptState(step=step, m=new_m, v=new_v), {
        "grad_norm": gnorm, "lr": lr}
