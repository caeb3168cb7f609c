"""Unified model: init / forward / prefill / decode for the decoder families.

The PyTorch counterpart of the JAX package's ``models/model.py`` for every
decoder-only architecture: periods of attention or Mamba-2 layers, each
followed by a dense MLP, a MoE layer or nothing. An encoder or patch
embeddings raise "not yet ported". The parameters are a :class:`Model`
module whose ``layers`` hold one ``{"pos<i>": Block}`` per period, where
the reference stacks each leaf on a leading ``n_periods`` axis; the
reference's ``lax.scan`` over periods is a Python loop over ``layers``.
There is no analysis mode and no rematerialisation (no backward yet).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models.config import LayerSpec, ModelConfig


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless every part of ``cfg`` is one the port has."""
    if cfg.enc_layers or cfg.num_patches:
        raise NotImplementedError(
            f"{cfg.name}: encoders, cross-attention and patch embeddings "
            "are not yet ported to repro_torch")


class Block(torch.nn.Module):
    """One position of the period (the reference's ``_period_pos_init``):
    its two norms, attention or a Mamba-2 mixer, then a dense MLP, a MoE
    layer or nothing (``norm2`` is unused without one, as in the
    reference)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 gen: torch.Generator, device=None):
        super().__init__()
        self.norm1 = L.norm_init(cfg, device=device)
        self.norm2 = L.norm_init(cfg, device=device)
        if spec.kind == "attn":
            self.attn = L.Attention(cfg, gen, device=device)
        else:
            self.mamba = M.Mamba2Mixer(cfg, gen, device=device)
        if spec.mlp == "dense":
            self.mlp = L.MLP(cfg, gen, device=device)
        elif spec.mlp == "moe":
            self.moe = MOE.MoE(cfg, gen, device=device)


class Model(torch.nn.Module):
    """The parameters of the reference's ``init_model`` tree."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dt = L._dtype(cfg.param_dtype)
        self.embed = L._frozen(
            L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device))
        if not cfg.tie_embeddings:
            self.unembed = L._frozen(
                L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt, device))
        self.final_norm = L.norm_init(cfg, device=device)
        self.layers = torch.nn.ModuleList(
            torch.nn.ModuleDict({f"pos{i}": Block(cfg, spec, gen, device)
                                 for i, spec in enumerate(cfg.period)})
            for _ in range(cfg.n_periods))


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """Weights drawn from a ``torch.Generator`` seeded with ``seed``, on
    ``device`` (CUDA unless the caller passes another; raises without a
    card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, gen, device=dev)


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------

def _apply_mlp(pp: Block, h, cfg: ModelConfig, spec: LayerSpec):
    """h after the position's MLP or MoE (if any), and the MoE aux loss
    (None without one)."""
    if spec.mlp == "dense":
        return h + L.apply_mlp(pp.mlp, L.apply_norm(pp.norm2, h, cfg), cfg), \
            None
    if spec.mlp == "moe":
        mo, aux = MOE.apply_moe(pp.moe, L.apply_norm(pp.norm2, h, cfg), cfg)
        return h + mo, aux
    return h, None


def _apply_pos_train(pp: Block, h, cfg: ModelConfig, spec: LayerSpec):
    hn = L.apply_norm(pp.norm1, h, cfg)
    if spec.kind == "attn":
        a, _ = L.attention_train(pp.attn, hn, cfg)
    else:
        a = M.mamba_forward(pp.mamba, hn, cfg)
    return _apply_mlp(pp, h + a, cfg, spec)


def forward_hidden(params: Model, tokens: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B,S,d), aux_loss): the MoE layers' aux losses
    summed in each period, then over the periods (0 without MoE)."""
    h = L.embed_tokens(params.embed, tokens, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    auxs = []
    for period in params.layers:
        aux = zero
        for i, spec in enumerate(cfg.period):
            h, a = _apply_pos_train(period[f"pos{i}"], h, cfg, spec)
            if a is not None:
                aux = aux + a
        auxs.append(aux)
    h = L.apply_norm(params.final_norm, h, cfg)
    return h, torch.stack(auxs).sum()


# --------------------------------------------------------------------------
# serving: decode state
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, ctx: int,
                      dtype=torch.bfloat16, device=None) -> Dict[str, List]:
    """Per-period caches: ``{"layers": [{"pos<i>": cache}, ...]}``, a KV
    cache of ``ctx`` positions (the window's, if smaller) at attention
    positions and a Mamba-2 cache elsewhere, whose state does not grow
    with ``ctx``."""
    check_ported(cfg)
    dev = resolve_device(device)

    def cache(spec):
        if spec.kind == "attn":
            return L.make_kv_cache(cfg, batch, ctx, dtype, device=dev)
        return M.make_mamba_cache(cfg, batch, dtype, device=dev)

    return {"layers": [{f"pos{i}": cache(spec)
                        for i, spec in enumerate(cfg.period)}
                       for _ in range(cfg.n_periods)]}


def _greedy(params: Model, h, cfg: ModelConfig):
    logits = L.logits_from_hidden(params, h, cfg).float()
    logits = L.mask_padded_vocab(logits, cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def decode_step(params: Model, state, token, cfg: ModelConfig):
    """One greedy decode step. token: (B,) int32. Returns (next_token, state)."""
    h = L.embed_tokens(params.embed, token[:, None], cfg)  # (B,1,d)
    new_layers = []
    for period, cache in zip(params.layers, state["layers"]):
        new_cache = {}
        for i, spec in enumerate(cfg.period):
            pp, key = period[f"pos{i}"], f"pos{i}"
            hn = L.apply_norm(pp.norm1, h, cfg)
            if spec.kind == "attn":
                a, new_cache[key] = L.attention_decode(pp.attn, hn,
                                                       cache[key], cfg)
            else:
                a, new_cache[key] = M.mamba_decode(pp.mamba, hn, cache[key],
                                                   cfg)
            h, _ = _apply_mlp(pp, h + a, cfg, spec)
        new_layers.append(new_cache)
    h = L.apply_norm(params.final_norm, h, cfg)
    new_state = dict(state)
    new_state["layers"] = new_layers
    return _greedy(params, h[:, 0], cfg), new_state


def prefill(params: Model, state, tokens, cfg: ModelConfig):
    """Fill caches from a prompt token by token through :func:`decode_step`;
    returns (state, the token predicted after the last one)."""
    nxt = None
    for tok in tokens.t():
        nxt, state = decode_step(params, state, tok, cfg)
    return state, nxt


def prefill_forward(params: Model, tokens, cfg: ModelConfig):
    """Batched prefill: full-sequence forward, then the greedy token after
    the last position (B,) int32."""
    h, _ = forward_hidden(params, tokens, cfg)
    return _greedy(params, h[:, -1], cfg)
