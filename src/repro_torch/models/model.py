"""Unified model: init / train forward / loss / prefill / decode for every family.

The PyTorch counterpart of the JAX package's ``models/model.py``: periods
of attention or Mamba-2 layers, each followed by a dense MLP, a MoE layer
or nothing; for an encoder-decoder (``enc_layers``) an encoder stack over
precomputed frame embeddings and a cross-attention in every decoder
block; for a vision-language model (``num_patches``) projected patch
embeddings prepended to the text. The activations pass the sharding
constraints of :mod:`repro_torch.train.sharding` where the reference's
do (identities outside its ``mesh_axes``). The parameters are a :class:`Model`
module whose ``layers`` hold one ``{"pos<i>": Block}`` per period (and
``enc_layers`` one :class:`Block` per encoder layer), where the reference
stacks each leaf on a leading axis; the reference's ``lax.scan`` over
periods is a Python loop over ``layers``. There is no analysis mode.
With ``cfg.remat`` and a trainable model, each period and each encoder
layer runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``; every config's ``remat_policy`` is "full", which
saves only the period's input, and the port has no other).

Two faults of the reference are reproduced, so that the packages agree:
the cross K/V cache of :func:`prefill` projects the encoder output
without the K and V biases that :func:`~repro_torch.models.layers.
attention_cross` adds, and a forward of an encoder-decoder without frame
embeddings fails in :func:`encode` (``None.to``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.train import sharding as SH

# an encoder layer: bidirectional attention, then a dense MLP
ENC_SPEC = LayerSpec(kind="attn", mlp="dense")


class Block(torch.nn.Module):
    """One position of the period (the reference's ``_period_pos_init``):
    its two norms, attention or a Mamba-2 mixer, then a dense MLP, a MoE
    layer or nothing (``norm2`` is unused without one, as in the
    reference); with ``cross``, the cross-attention ``xattn`` and its norm
    ``norm_x``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 gen: torch.Generator, device=None, cross: bool = False):
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
        if cross:
            self.norm_x = L.norm_init(cfg, device=device)
            self.xattn = L.Attention(cfg, gen, device=device)


class Model(torch.nn.Module):
    """The parameters of the reference's ``init_model`` tree."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.cfg = cfg
        dt = L._dtype(cfg.param_dtype)
        self.embed = L._frozen(
            L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device))
        if not cfg.tie_embeddings:
            self.unembed = L._frozen(
                L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt, device))
        self.final_norm = L.norm_init(cfg, device=device)
        cross = cfg.enc_layers > 0
        self.layers = torch.nn.ModuleList(
            torch.nn.ModuleDict({f"pos{i}": Block(cfg, spec, gen, device,
                                                  cross)
                                 for i, spec in enumerate(cfg.period)})
            for _ in range(cfg.n_periods))
        if cfg.enc_layers:
            self.enc_layers = torch.nn.ModuleList(
                Block(cfg, ENC_SPEC, gen, device)
                for _ in range(cfg.enc_layers))
            self.enc_norm = L.norm_init(cfg, device=device)
        if cfg.num_patches:
            self.patch_proj = L._frozen(
                L.dense_init(gen, cfg.d_model, cfg.d_model, dt, device))


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """Weights drawn from a ``torch.Generator`` seeded with ``seed``, on
    ``device`` (CUDA unless the caller passes another; raises without a
    card). On ``meta`` the tensors have shapes and dtypes and no data (the
    dry run's stand-ins; a meta generator does not exist, so a CPU one is
    passed and draws nothing). The parameters are frozen; training turns
    them on."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    return Model(cfg, gen, device=dev)


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------

def _remat(params: Model, cfg: ModelConfig) -> bool:
    """Whether periods run under ``torch.utils.checkpoint``: with
    ``cfg.remat``, while autograd records and the model is trainable."""
    return (cfg.remat and torch.is_grad_enabled()
            and params.embed.requires_grad)


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


def _apply_pos_train(pp: Block, h, cfg: ModelConfig, spec: LayerSpec,
                     enc_out=None):
    hn = L.apply_norm(pp.norm1, h, cfg)
    if spec.kind == "attn":
        a, _ = L.attention_train(pp.attn, hn, cfg)
    else:
        a = M.mamba_forward(pp.mamba, hn, cfg)
    h = h + a
    if enc_out is not None and hasattr(pp, "xattn"):
        h = h + L.attention_cross(pp.xattn, L.apply_norm(pp.norm_x, h, cfg),
                                  enc_out, cfg)
    return _apply_mlp(pp, h, cfg, spec)


def _period(period, h, enc_out, cfg: ModelConfig):
    """One period: (h, the MoE aux losses of its positions summed)."""
    aux = SH.like(torch.zeros((), dtype=torch.float32, device=h.device), h)
    for i, spec in enumerate(cfg.period):
        h, a = _apply_pos_train(period[f"pos{i}"], h, cfg, spec, enc_out)
        h = SH.constrain_acts(h)
        if a is not None:
            aux = aux + a
    return h, aux


def forward_hidden(params: Model, tokens: torch.Tensor, cfg: ModelConfig, *,
                   frontend_embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B,S,d), aux_loss): the MoE layers' aux losses
    summed in each period, then over the periods (0 without MoE).
    ``frontend_embeds`` (B, P, d): patch embeddings, projected and
    prepended to the text (``num_patches``), or the encoder's frames
    (``enc_layers``)."""
    h = L.embed_tokens(params.embed, tokens, cfg)
    if cfg.num_patches and frontend_embeds is not None:
        cdt = L._dtype(cfg.compute_dtype)
        pe = frontend_embeds.to(cdt) @ SH.gather_fsdp(params.patch_proj).to(cdt)
        h = torch.cat([pe, h], dim=1)
    enc_out = encode(params, frontend_embeds, cfg) if cfg.enc_layers else None
    h = SH.constrain_acts(h)
    remat = _remat(params, cfg)
    auxs = []
    for period in params.layers:
        if remat:
            h, aux = checkpoint(_period, period, h, enc_out, cfg,
                                use_reentrant=False)
        else:
            h, aux = _period(period, h, enc_out, cfg)
        auxs.append(aux)
    h = L.apply_norm(params.final_norm, h, cfg)
    return h, torch.stack(auxs).sum()


def _enc_layer(pp: Block, h, cfg: ModelConfig):
    h = h + L.attention_bidir(pp.attn, L.apply_norm(pp.norm1, h, cfg), cfg)
    return h + L.apply_mlp(pp.mlp, L.apply_norm(pp.norm2, h, cfg), cfg)


def encode(params: Model, frame_embeds: torch.Tensor, cfg: ModelConfig):
    """The encoder stack over precomputed frame embeddings (B, P, d)."""
    h = frame_embeds.to(L._dtype(cfg.compute_dtype))
    remat = _remat(params, cfg)
    for pp in params.enc_layers:
        if remat:
            h = checkpoint(_enc_layer, pp, h, cfg, use_reentrant=False)
        else:
            h = _enc_layer(pp, h, cfg)
    return L.apply_norm(params.enc_norm, h, cfg)


def lm_loss(params: Model, tokens, targets, cfg: ModelConfig,
            frontend_embeds=None):
    """(loss + 0.01 · aux, (loss, aux)): the flash cross-entropy's mean
    NLL over the text positions (the patches are cut off)."""
    h, aux = forward_hidden(params, tokens, cfg,
                            frontend_embeds=frontend_embeds)
    if cfg.num_patches and frontend_embeds is not None:
        h = h[:, cfg.num_patches:]  # loss only over text positions
    loss = L.lm_loss_flash(params, h, targets, cfg)
    return loss + 0.01 * aux, (loss, aux)


# --------------------------------------------------------------------------
# serving: decode state
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, ctx: int,
                      dtype=torch.bfloat16, device=None,
                      with_xkv: bool = False) -> Dict[str, List]:
    """Per-period caches: ``{"layers": [{"pos<i>": cache}, ...]}``, a KV
    cache of ``ctx`` positions (the window's, if smaller) at attention
    positions and a Mamba-2 cache elsewhere, whose state does not grow
    with ``ctx``. An encoder-decoder's state also has ``"xkv"``: None
    (filled by :func:`prefill`) or, ``with_xkv``, zero cross K/V of
    ``enc_seq`` frames per period position, ``[{"pos<i>": (k, v)}, ...]``.
    """
    dev = resolve_device(device)

    def cache(spec):
        if spec.kind == "attn":
            return L.make_kv_cache(cfg, batch, ctx, dtype, device=dev)
        return M.make_mamba_cache(cfg, batch, dtype, device=dev)

    state = {"layers": [{f"pos{i}": cache(spec)
                         for i, spec in enumerate(cfg.period)}
                        for _ in range(cfg.n_periods)]}
    if cfg.enc_layers:
        shape = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.d_head)

        def kv():
            return torch.zeros(shape, dtype=dtype, device=dev)

        state["xkv"] = ([{f"pos{i}": (kv(), kv())
                          for i in range(len(cfg.period))}
                         for _ in range(cfg.n_periods)] if with_xkv else None)
    return state


def _greedy(params: Model, h, cfg: ModelConfig):
    """The most likely token of each row; a DTensor's logits (one
    position a row) are gathered whole on every rank first."""
    logits = L.logits_from_hidden(params, h, cfg).float()
    logits = L.mask_padded_vocab(SH.replicate(logits), cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def decode_step(params: Model, state, token, cfg: ModelConfig):
    """One greedy decode step. token: (B,) int32. Returns (next_token,
    state); with cross K/V in the state, every decoder block attends to
    them."""
    h = L.embed_tokens(params.embed, token[:, None], cfg)  # (B,1,d)
    xkv = state.get("xkv")
    new_layers = []
    for pi, (period, cache) in enumerate(zip(params.layers, state["layers"])):
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
            h = h + a
            if xkv is not None and hasattr(pp, "xattn"):
                h = h + _cross_decode(pp, h, xkv[pi][key], cfg)
            h, _ = _apply_mlp(pp, h, cfg, spec)
        new_layers.append(new_cache)
    h = L.apply_norm(params.final_norm, h, cfg)
    new_state = dict(state)
    new_state["layers"] = new_layers
    return _greedy(params, h[:, 0], cfg), new_state


def _q_only(p, x, cfg: ModelConfig):
    cdt = L._dtype(cfg.compute_dtype)
    B, S, _ = x.shape
    q = x.to(cdt) @ SH.gather_fsdp(p.wq).to(cdt)
    if cfg.qkv_bias:
        q = q + p.bq.to(cdt)
    return q.reshape(B, S, cfg.n_heads, cfg.d_head)


def _cross_decode(pp: Block, h, xkv, cfg: ModelConfig):
    """Cross-attention of one decode token against the encoder K/V cached
    at prefill (float32 products: the reference passes no
    ``matmul_bf16`` here)."""
    k, v = xkv
    o = L.chunked_attention(
        _q_only(pp.xattn, L.apply_norm(pp.norm_x, h, cfg), cfg), k, v,
        causal=False)
    cdt = L._dtype(cfg.compute_dtype)
    return SH.reduce_partial(o.reshape(h.shape[0], 1, cfg.d_qkv).to(cdt)
                             @ SH.gather_fsdp(pp.xattn.wo).to(cdt))


def _encode_xkv(params: Model, enc_out, cfg: ModelConfig):
    """Cross-attention K/V of every decoder period position, projected by
    ``wk`` and ``wv`` alone: the reference leaves out ``bk`` and ``bv``
    here, which :func:`~repro_torch.models.layers.attention_cross` adds."""
    cdt = L._dtype(cfg.compute_dtype)
    B, Skv, _ = enc_out.shape
    e = enc_out.to(cdt)
    shape = (B, Skv, cfg.n_kv_heads, cfg.d_head)
    return [{f"pos{i}": ((e @ SH.gather_fsdp(period[f"pos{i}"].xattn.wk).to(cdt)).reshape(
                 shape),
                         (e @ SH.gather_fsdp(period[f"pos{i}"].xattn.wv).to(cdt)).reshape(
                 shape))
             for i in range(len(cfg.period))}
            for period in params.layers]


def attach_xkv(params: Model, state, frontend_embeds, cfg: ModelConfig):
    """A copy of the decode ``state`` holding the cross K/V of the
    encoded ``frontend_embeds`` (B, enc_seq, d), as :func:`_encode_xkv`
    projects it."""
    state = dict(state)
    state["xkv"] = _encode_xkv(params, encode(params, frontend_embeds, cfg),
                               cfg)
    return state


def prefill(params: Model, state, tokens, cfg: ModelConfig,
            frontend_embeds=None):
    """Fill caches from a prompt token by token through :func:`decode_step`;
    returns (state, the token predicted after the last one). An
    encoder-decoder given frame embeddings encodes them first and puts
    their cross K/V into the state."""
    if cfg.enc_layers and frontend_embeds is not None:
        state = attach_xkv(params, state, frontend_embeds, cfg)
    nxt = None
    for tok in tokens.t():
        nxt, state = decode_step(params, state, tok, cfg)
    return state, nxt


def prefill_forward(params: Model, tokens, cfg: ModelConfig,
                    frontend_embeds=None):
    """Batched prefill: full-sequence forward, then the greedy token after
    the last position (B,) int32."""
    h, _ = forward_hidden(params, tokens, cfg,
                          frontend_embeds=frontend_embeds)
    return _greedy(params, h[:, -1], cfg)
