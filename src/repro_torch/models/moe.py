"""Mixture-of-Experts layer (token-choice top-k, capacity-based dispatch).

The PyTorch counterpart of the JAX package's ``models/moe.py``. Dispatch
is per row (per sequence): each expert takes the top-C tokens among those
of the row that routed to it (C = k·S·cf/E, rounded up to a multiple of 8
and at most S), gathers them into an (B, E, C, d) block, runs batched
expert products, and scatter-adds the outputs back weighted by the
gates. Expert weights are stacked (E, d, ff).

``lax.top_k`` puts the lower index first among equal values; ``torch.topk``
promises no order, so both selections here are stable sorts. Tokens an
expert takes only among the ``NEG_INF`` scores of tokens that did not
pick it carry weight 0 and add nothing. The scatter-add is ``index_add_``:
in index order on the CPU, in another order on the card (other bits,
within float32 rounding).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.config import ModelConfig
from repro_torch.train import sharding as SH
from repro_torch.models.layers import (
    NEG_INF, _dtype, _frozen, activate, dense_init, mlp_weights)


class MoE(torch.nn.Module):
    """The parameters of one MoE layer (the reference's ``moe_init``
    tree, under the same names): a float32 ``router`` (d, E) and the
    experts' ``w_gate`` (swiglu only), ``w_up`` and ``w_down`` stacked on
    a leading E axis, in ``param_dtype``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        E = cfg.moe_num_experts
        self.router = _frozen(dense_init(gen, cfg.d_model, E, torch.float32,
                                         device))
        for name, value in mlp_weights(cfg, gen, cfg.moe_d_ff, device,
                                       stack=(E,)).items():
            self.register_parameter(name, _frozen(value))


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Tokens an expert takes from a row of ``n_tokens``: k·S·cf/E rounded
    up to a multiple of 8, at most the row (1 at decode)."""
    cap = int(math.ceil(cfg.moe_top_k * n_tokens * cfg.moe_capacity_factor
                        / cfg.moe_num_experts))
    return min(max(8, -(-cap // 8) * 8), n_tokens)


def no_drop(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with a capacity factor of E/k, at which an expert can take
    every token of a row (C = S), so that no token is dropped; ``cfg``
    itself without MoE. A forward at the config's factor drops the tokens
    past an expert's capacity, which decode (one token, C = 1) never
    does; at this one the two compute the same function."""
    if not cfg.moe_num_experts:
        return cfg
    return cfg.replace(
        moe_capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)


def _top(x, k: int):
    """The k largest along the last axis, lower index first among equals
    (``lax.top_k``'s order): (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, router, C: int, K: int, cdt):
    """Row-local dispatch: each expert's top-C tokens of the row, gathered.
    Returns xe (B, E, C, d) in ``cdt``, their indices into S (B, E, C),
    their gates (0 for a token the expert did not pick), and the row
    means of the aux loss: the fraction of tokens routed to each expert
    and its mean probability, (E,) each."""
    B, S, d = x.shape
    probs = torch.softmax(x.float() @ router, dim=-1)  # (B, S, E)
    E = probs.shape[-1]
    top_p, top_e = _top(probs, K)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)  # renormalise

    # per-expert score (B, E, S): the gate, NEG_INF where e was not picked
    chose = torch.zeros((B, S, E), dtype=torch.float32, device=x.device)
    chose.scatter_(-1, top_e, top_p)
    score = torch.where(chose > 0, chose, NEG_INF).transpose(1, 2)

    sel_score, sel_idx = _top(score, C)  # (B, E, C) indices into S
    weight = torch.where(sel_score > NEG_INF / 2, sel_score, 0.0)

    rows = torch.arange(B, device=x.device)[:, None]
    xe = x.to(cdt)[rows, sel_idx.reshape(B, E * C)].reshape(B, E, C, d)
    frac_tokens = (chose > 0).float().mean(dim=(0, 1))  # (E,)
    frac_prob = probs.mean(dim=(0, 1))
    return xe, sel_idx, weight, frac_tokens, frac_prob


def _combine(ye, sel_idx, weight, S: int, dtype):
    """Row-local: the experts' outputs (B, E, C, d) weighted by their gates
    and added back at their tokens, (B, S, d) in ``dtype``."""
    B, d = ye.shape[0], ye.shape[-1]
    rows = torch.arange(B, device=ye.device)[:, None]
    yw = ye.float() * weight[..., None]
    flat = (sel_idx + rows[..., None] * S).reshape(-1)
    out = torch.zeros((B * S, d), dtype=torch.float32, device=ye.device)
    out.index_add_(0, flat, yw.reshape(-1, d))
    return out.reshape(B, S, d).to(dtype)


def _row_local(fn, x, n_rows: int, n_whole: int, outs):
    """``fn`` through ``local_map`` for a DTensor ``x`` (B, ...): the mesh
    dims that shard x's batch evenly shard dim 0 of the first ``n_rows``
    arguments (the next ``n_whole`` are whole on every rank, their
    gradients partial sums) and of each output
    that ``outs`` calls "rows" (a "mean" is a mean over the rows); every
    other mesh dim is replicated."""
    mesh = x.device_mesh
    batch = [p == Shard(0) and x.shape[0] % mesh.size(i) == 0
             for i, p in enumerate(x.placements)]

    def lay(on_batch):
        return tuple(on_batch if b else Replicate() for b in batch)

    return local_map(
        fn, device_mesh=mesh, redistribute_inputs=True,
        out_placements=tuple(lay(Shard(0) if o == "rows" else Partial("avg"))
                             for o in outs),
        in_placements=(lay(Shard(0)),) * n_rows + (lay(Replicate()),) * n_whole,
        # a rank's gradient of a whole argument sums over its rows alone
        in_grad_placements=(lay(Shard(0)),) * n_rows
        + (lay(Partial()),) * n_whole)


def apply_moe(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (out in x's dtype, the Switch-style
    load-balancing aux loss, float32). Dispatch and combine are row-local:
    for DTensors (the sharded model) they run on each rank's rows through
    ``local_map``, and the expert products between them on DTensors."""
    cdt = _dtype(cfg.compute_dtype)
    B, S, d = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    C = expert_capacity(cfg, S)
    route = functools.partial(_route, C=C, K=K, cdt=cdt)
    combine = functools.partial(_combine, S=S, dtype=x.dtype)
    mesh = isinstance(x, DTensor)
    if mesh:
        route = _row_local(route, x, 1, 1,
                           ("rows", "rows", "rows", "mean", "mean"))
        combine = _row_local(combine, x, 3, 0, ("rows",))
    xe, sel_idx, weight, frac_tokens, frac_prob = route(x, p.router)
    # keep the dispatch batch-sharded: the expert weights are gathered,
    # the token batch is not replicated
    xe = SH.constrain(xe, ("batch", None, None, None))
    w_up, w_down = SH.gather_fsdp(p.w_up), SH.gather_fsdp(p.w_down)
    gate = (torch.einsum("becd,edf->becf", xe,
                         SH.gather_fsdp(p.w_gate).to(cdt))
            if cfg.mlp_act == "swiglu" else None)
    h = activate(torch.einsum("becd,edf->becf", xe, w_up.to(cdt)), gate,
                 cfg)
    h = SH.constrain(h, ("batch", None, None, "model"))
    ye = torch.einsum("becf,efd->becd", h, w_down.to(cdt))  # (B,E,C,d)
    ye = SH.constrain(ye, ("batch", None, None, None))
    out = combine(ye, sel_idx, weight)
    aux = E * torch.sum(frac_tokens * frac_prob)
    return out, aux
