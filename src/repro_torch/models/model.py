"""Unified model: init / forward / prefill / decode for the ported families.

The PyTorch counterpart of the JAX package's ``models/model.py`` for
periods of Mamba-2 layers without an MLP (``mamba2_370m``); any other
layer spec, an encoder or patch embeddings raise "not yet ported". The
parameters are a :class:`Model` module whose ``layers`` hold one
``{"pos<i>": Block}`` per period, where the reference stacks each leaf on
a leading ``n_periods`` axis; the reference's ``lax.scan`` over periods
is a Python loop over ``layers``. There is no analysis mode.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.config import ModelConfig


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless every layer of ``cfg`` is one the port has."""
    for spec in cfg.period:
        if spec.kind != "mamba" or spec.mlp != "none":
            raise NotImplementedError(
                f"{cfg.name}: layer kind={spec.kind!r} mlp={spec.mlp!r} is "
                "not yet ported to repro_torch (only Mamba-2 layers without "
                "an MLP are)")
    if cfg.enc_layers or cfg.num_patches or cfg.norm != "rmsnorm" \
            or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: encoders, patch embeddings, LayerNorm and untied "
            "unembeddings are not yet ported to repro_torch")


class Block(torch.nn.Module):
    """One position of the period: its two norms and its Mamba-2 mixer
    (``norm2`` is unused without an MLP, as in the reference)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.norm1 = L.norm_init(cfg, device=device)
        self.norm2 = L.norm_init(cfg, device=device)
        self.mamba = M.Mamba2Mixer(cfg, gen, device=device)


class Model(torch.nn.Module):
    """The parameters of the reference's ``init_model`` tree."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dt = L._dtype(cfg.param_dtype)
        self.embed = torch.nn.Parameter(
            L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device),
            requires_grad=False)
        self.final_norm = L.norm_init(cfg, device=device)
        self.layers = torch.nn.ModuleList(
            torch.nn.ModuleDict({f"pos{i}": Block(cfg, gen, device)
                                 for i in range(len(cfg.period))})
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

def _apply_pos_train(pp: Block, h, cfg: ModelConfig):
    a = M.mamba_forward(pp.mamba, L.apply_norm(pp.norm1, h, cfg), cfg)
    return h + a


def forward_hidden(params: Model, tokens: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B,S,d), aux_loss); the aux loss is 0 without MoE."""
    h = L.embed_tokens(params.embed, tokens, cfg)
    for period in params.layers:
        for i in range(len(cfg.period)):
            h = _apply_pos_train(period[f"pos{i}"], h, cfg)
    h = L.apply_norm(params.final_norm, h, cfg)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


# --------------------------------------------------------------------------
# serving: decode state
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, ctx: int,
                      dtype=torch.bfloat16, device=None) -> Dict[str, List]:
    """Per-period caches: ``{"layers": [{"pos<i>": cache}, ...]}``.
    ``ctx`` sizes attention caches; Mamba-2 state does not grow with it."""
    check_ported(cfg)
    dev = resolve_device(device)
    return {"layers": [
        {f"pos{i}": M.make_mamba_cache(cfg, batch, dtype, device=dev)
         for i in range(len(cfg.period))}
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
        for i in range(len(cfg.period)):
            pp = period[f"pos{i}"]
            hn = L.apply_norm(pp.norm1, h, cfg)
            a, new_cache[f"pos{i}"] = M.mamba_decode(
                pp.mamba, hn, cache[f"pos{i}"], cfg)
            h = h + a
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
