"""Core model layers (functions over tensors).

The PyTorch counterpart of the JAX package's ``models/layers.py``: dtypes,
initialisers, RMSNorm and LayerNorm, rotary embeddings, attention (causal,
bidirectional and cross, as a chunked online-softmax forward with the
reference's recomputing backward; single-token decode against a KV
cache), the dense MLPs, the embedding, the tied or untied unembedding and
the two cross-entropies (chunked, and the flash one with its recomputing
backward). ``cfg.compute_dtype`` is used inside the projections;
normalisation, softmax and RoPE run in float32, and so do the attention
score and PV products unless ``cfg.attn_bf16``. The sharding constraints
of the reference are no-ops on one device and are not ported.

Parameters are built frozen (``requires_grad=False``), so that serving
records no autograd graph; the train step turns gradients on for the
model it trains (``repro_torch.train.train_step.init_state``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

# keys per block of the online-softmax attention
KV_CHUNK = 1024
NEG_INF = -1e30


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _frozen(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=False)


# --------------------------------------------------------------------------
# init helpers (the JAX package's distributions; a torch.Generator draws
# other numbers than a JAX key, so tests carry weights over instead)
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device=None, stack=()) -> torch.Tensor:
    """N(0, 1/d_in) weights of shape ``stack + (d_in, d_out)``."""
    w = torch.randn(tuple(stack) + (d_in, d_out), generator=gen,
                    dtype=torch.float32, device=device)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, d: Optional[int] = None,
              device=None) -> torch.nn.ParameterDict:
    """The norm's float32 ``scale`` (ones), and its ``bias`` (zeros) for
    LayerNorm."""
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return torch.nn.ParameterDict({k: _frozen(v) for k, v in p.items()})


def apply_norm(p, x, cfg: ModelConfig):
    """LayerNorm (population variance, eps 1e-5) or RMSNorm (eps 1e-6) in
    float32, returned in ``x``'s dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, d_head); positions: (..., S). Rotates the two halves
    of each head (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions[..., None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

class Attention(torch.nn.Module):
    """The parameters of one attention layer (the reference's
    ``attn_init`` tree, under the same names): ``wq, wk, wv, wo`` in
    ``param_dtype`` and, with ``qkv_bias``, float32 ``bq, bk, bv``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        d, dq = cfg.d_model, cfg.d_qkv
        dkv = cfg.n_kv_heads * cfg.d_head
        init = {"wq": dense_init(gen, d, dq, dt, device),
                "wk": dense_init(gen, d, dkv, dt, device),
                "wv": dense_init(gen, d, dkv, dt, device),
                "wo": dense_init(gen, dq, d, dt, device)}
        if cfg.qkv_bias:
            for name, width in (("bq", dq), ("bk", dkv), ("bv", dkv)):
                init[name] = torch.zeros((width,), dtype=torch.float32,
                                         device=device)
        for name, value in init.items():
            self.register_parameter(name, _frozen(value))


def _project_qkv(p, xq, xkv, cfg: ModelConfig):
    cdt = _dtype(cfg.compute_dtype)
    B, Sq = xq.shape[0], xq.shape[1]
    Skv = xkv.shape[1]
    q = xq.to(cdt) @ p.wq.to(cdt)
    k = xkv.to(cdt) @ p.wk.to(cdt)
    v = xkv.to(cdt) @ p.wv.to(cdt)
    if cfg.qkv_bias:
        q = q + p.bq.to(cdt)
        k = k + p.bk.to(cdt)
        v = v + p.bv.to(cdt)
    q = q.reshape(B, Sq, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, Skv, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, Skv, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def _chunk_mask(valb, k_pos, q_pos, causal: bool, window: int):
    """(B, Sq, chunk): key valid, and causal / inside the window."""
    mask = valb[:, None, :].expand(-1, q_pos.shape[0], -1)
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[None, :, None])
    if window:
        mask = mask & (k_pos[None, None, :] > q_pos[None, :, None] - window)
    return mask


def _mm_operand(x, bf16: bool):
    """A float32 operand of the score or PV product; with ``bf16`` rounded
    to bfloat16 first. Products of two bfloat16 values are exact in
    float32, so a float32 product of rounded operands is the reference's
    bfloat16 product with float32 accumulation."""
    x = x.float()
    return x.to(torch.bfloat16).float() if bf16 else x


def _grouped(t, Hkv):
    """(B, S, H, dh) -> (B, Hkv, rep·S, dh): query head h = g·rep + r in
    group g, row r·S + s."""
    B, S, H, dh = t.shape
    rep = H // Hkv
    return t.reshape(B, S, Hkv, rep, dh).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, rep * S, dh)


def _ungrouped(t, S):
    """The inverse of :func:`_grouped`: (B, Hkv, rep·S, dh) -> (B, S, H, dh)."""
    B, Hkv, RS, dh = t.shape
    rep = RS // S
    return t.reshape(B, Hkv, rep, S, dh).permute(0, 3, 1, 2, 4).reshape(
        B, S, Hkv * rep, dh)


def _chunk_scores(qg, kb, kvv, sl, c, chunk, Sq, rep, causal, window,
                  scale):
    """Chunk ``c``'s (keys ``sl``) scaled scores (B, Hkv, rep, Sq, chunk)
    float32 from the grouped queries and the chunk's keys kb (B, Hkv, dh,
    chunk), ``NEG_INF`` where the key is masked."""
    B, Hkv = qg.shape[0], qg.shape[1]
    s = (qg @ kb).mul_(scale).view(B, Hkv, rep, Sq, chunk)
    q_pos = torch.arange(Sq, device=qg.device)
    k_pos = c * chunk + torch.arange(chunk, device=qg.device)
    mask = _chunk_mask(kvv[:, sl], k_pos, q_pos, causal, window)
    return s.masked_fill_(~mask[:, None, None], NEG_INF)


def _flash_fwd(q, kp, vp, kvv, causal: bool, window: int, chunk: int,
               mm_bf16: bool):
    """The reference's ``_flash_fwd_scan`` as a loop over key chunks.

    q: (B, Sq, H, dh); kp, vp: (B, Skv, Hkv, dh) with Skv a multiple of
    ``chunk``; kvv: (B, Skv) bool. Query head h reads KV head h // rep
    (``jnp.repeat`` along heads): the queries are grouped by KV head,
    (B, Hkv, rep·Sq, dh), so each KV chunk is read once per group and
    never repeated. Returns o (B, Sq, H, dh) float32 and the softmax's
    log-sum-exp ``lse`` (B, Hkv, rep, Sq) float32.
    """
    B, Sq, H, dh = q.shape
    Hkv = kp.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    n_chunks = kp.shape[1] // chunk
    qg = _grouped(_mm_operand(q, mm_bf16), Hkv)
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, rep * Sq, dh), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kb = _mm_operand(kp[:, sl], mm_bf16).permute(0, 2, 3, 1)  # B,g,d,k
        vb = _mm_operand(vp[:, sl], mm_bf16).permute(0, 2, 1, 3)  # B,g,k,d
        s = _chunk_scores(qg, kb, kvv, sl, c, chunk, Sq, rep, causal, window,
                          scale)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = _mm_operand(p, mm_bf16).view(B, Hkv, rep * Sq, chunk) @ vb
        acc = acc * corr.reshape(B, Hkv, rep * Sq, 1) + pv
        m = m_new
    l = torch.clamp(l, min=1e-30)
    o = acc.view(B, Hkv, rep, Sq, dh) / l[..., None]
    return _ungrouped(o.view(B, Hkv, rep * Sq, dh), Sq), m + torch.log(l)


def _flash_bwd(do, q, kp, vp, kvv, o, lse, causal: bool, window: int,
               chunk: int, mm_bf16: bool):
    """The reference's ``_flash_attn_bwd``: each chunk's probabilities are
    recomputed from the saved ``lse`` (O(S·chunk) live memory, not
    autograd's O(S²)), and the GQA query heads fold back onto their KV
    head through the grouped layout. Returns float32 dq (B, Sq, H, dh),
    dk and dv (B, Skv, Hkv, dh)."""
    B, Sq, H, dh = q.shape
    Skv, Hkv = kp.shape[1], kp.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qg = _grouped(_mm_operand(q, mm_bf16), Hkv)
    dog = _grouped(_mm_operand(do, mm_bf16), Hkv)
    delta = (do.float() * o).sum(dim=-1)  # (B, Sq, H)
    delta = delta.reshape(B, Sq, Hkv, rep).permute(0, 2, 3, 1)[..., None]
    dq = torch.zeros((B, Hkv, rep * Sq, dh), dtype=torch.float32,
                     device=q.device)
    dk = torch.empty((B, Skv, Hkv, dh), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for c in range(Skv // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        kb = _mm_operand(kp[:, sl], mm_bf16).permute(0, 2, 3, 1)  # B,g,d,k
        vb = _mm_operand(vp[:, sl], mm_bf16).permute(0, 2, 3, 1)  # B,g,d,k
        s = _chunk_scores(qg, kb, kvv, sl, c, chunk, Sq, rep, causal, window,
                          scale)
        p = s.sub_(lse[..., None]).exp_()  # exact probabilities
        dp = (dog @ vb).view(B, Hkv, rep, Sq, chunk)
        dsm = _mm_operand(p * (dp - delta), mm_bf16).view(
            B, Hkv, rep * Sq, chunk)
        dq = dq + scale * (dsm @ kb.transpose(-1, -2))
        dk[:, sl] = (scale * (dsm.transpose(-1, -2) @ qg)).permute(0, 2, 1, 3)
        pm = _mm_operand(p, mm_bf16).view(B, Hkv, rep * Sq, chunk)
        dv[:, sl] = (pm.transpose(-1, -2) @ dog).permute(0, 2, 1, 3)
    return _ungrouped(dq, Sq), dk, dv


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_attn`` (a ``custom_vjp``): the chunked
    forward, and a backward that recomputes each chunk's scores."""

    @staticmethod
    def forward(ctx, q, kp, vp, kvv, causal, window, chunk, mm_bf16):
        o, lse = _flash_fwd(q, kp, vp, kvv, causal, window, chunk, mm_bf16)
        ctx.static = (causal, window, chunk, mm_bf16)
        ctx.save_for_backward(q, kp, vp, kvv, o, lse)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, kp, vp, kvv, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(do, q, kp, vp, kvv, o, lse, *ctx.static)
        return (dq.to(q.dtype), dk.to(kp.dtype), dv.to(vp.dtype), None, None,
                None, None, None)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0,
                      kv_valid: Optional[torch.Tensor] = None,
                      chunk: int = KV_CHUNK,
                      matmul_bf16: bool = False) -> torch.Tensor:
    """Flash attention: online softmax over KV chunks, with the
    reference's recomputing backward. q: (B, Sq, H, dh); k, v: (B, Skv,
    Hkv, dh); kv_valid: optional (B, Skv) bool. Keys are padded to a
    multiple of the chunk and masked; masked scores are ``NEG_INF``, not
    -inf, so a row with no valid key averages the values (as the
    reference does). Returns (B, Sq, H, dh) in q's dtype."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    chunk = min(chunk, Skv)
    n_chunks = (Skv + chunk - 1) // chunk
    pad = n_chunks * chunk - Skv
    kvv = torch.arange(n_chunks * chunk, device=q.device) < Skv
    kvv = kvv[None].expand(B, -1)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    if kv_valid is not None:
        kvv = F.pad(kv_valid, (0, pad)) & kvv
    return _FlashAttention.apply(q, k, v, kvv, bool(causal), int(window),
                                 int(chunk), bool(matmul_bf16))


def attention_train(p, x, cfg: ModelConfig, positions=None):
    """Causal self-attention over a full sequence (training / prefill).
    Returns (out (B,S,d), (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=True, window=cfg.sliding_window,
                          matmul_bf16=cfg.attn_bf16)
    cdt = _dtype(cfg.compute_dtype)
    o = o.reshape(B, S, cfg.d_qkv).to(cdt) @ p.wo.to(cdt)
    return o, (k, v)


def attention_bidir(p, x, cfg: ModelConfig):
    """Bidirectional self-attention (the encoder), with RoPE on the frames
    as the reference applies it."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=False, matmul_bf16=cfg.attn_bf16)
    cdt = _dtype(cfg.compute_dtype)
    return o.reshape(B, S, cfg.d_qkv).to(cdt) @ p.wo.to(cdt)


def attention_cross(p, x, enc_out, cfg: ModelConfig):
    """Cross-attention from the decoder's x to the encoder's output (no
    RoPE; K and V with their biases)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, enc_out, cfg)
    o = chunked_attention(q, k, v, causal=False, matmul_bf16=cfg.attn_bf16)
    cdt = _dtype(cfg.compute_dtype)
    return o.reshape(B, S, cfg.d_qkv).to(cdt) @ p.wo.to(cdt)


def make_kv_cache(cfg: ModelConfig, batch: int, ctx: int,
                  dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """K and V (batch, T, Hkv, dh) and the int32 scalar ``pos``; T is the
    window for sliding-window layers (a ring) and ``ctx`` otherwise."""
    T = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
    shape = (batch, T, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def attention_decode(p, x, cache, cfg: ModelConfig):
    """Single-token decode against a KV cache (x: (B, 1, d)).

    Every row shares the cache's scalar ``pos``; sliding-window layers
    write slot ``pos % T`` of a ring. On a full-attention cache a ``pos``
    past its end writes slot T - 1, where ``lax.dynamic_update_slice``
    clamps the reference's start. Returns (out (B,1,d), new cache); the
    cache passed in is not changed.
    """
    B = x.shape[0]
    T = cache["k"].shape[1]
    pos = cache["pos"]
    q, k, v = _project_qkv(p, x, x, cfg)  # Sq = 1
    at = pos.expand(B, 1)
    q = apply_rope(q, at, cfg.rope_theta)
    k = apply_rope(k, at, cfg.rope_theta)
    slot = pos % T if cfg.sliding_window else torch.clamp(pos, max=T - 1)
    where = slot.reshape(1).long()
    ck = cache["k"].index_copy(1, where, k.to(cache["k"].dtype))
    cv = cache["v"].index_copy(1, where, v.to(cache["v"].dtype))
    idx = torch.arange(T, device=x.device)
    if cfg.sliding_window:
        valid = (idx <= slot) | (pos >= T)  # a ring: all valid once wrapped
    else:
        valid = idx <= pos
    scale = 1.0 / math.sqrt(cfg.d_head)
    Hkv = cfg.n_kv_heads
    rep = cfg.n_heads // Hkv
    qg = (q.float() * scale).reshape(B, Hkv, rep, cfg.d_head)
    s = qg @ ck.float().permute(0, 2, 3, 1)  # (B, Hkv, rep, T)
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = w @ cv.float().permute(0, 2, 1, 3)  # (B, Hkv, rep, dh)
    cdt = _dtype(cfg.compute_dtype)
    o = o.reshape(B, 1, cfg.d_qkv).to(cdt) @ p.wo.to(cdt)
    return o, {"k": ck, "v": cv, "pos": pos + 1}


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_weights(cfg: ModelConfig, gen: torch.Generator, d_ff: int,
                device=None, stack=()) -> Dict[str, torch.Tensor]:
    """``w_gate`` (swiglu only), ``w_up`` and ``w_down`` in
    ``param_dtype``, each of shape ``stack + (d_in, d_out)``."""
    dt = _dtype(cfg.param_dtype)
    d = cfg.d_model
    names = ("w_gate", "w_up") if cfg.mlp_act == "swiglu" else ("w_up",)
    w = {n: dense_init(gen, d, d_ff, dt, device, stack) for n in names}
    w["w_down"] = dense_init(gen, d_ff, d, dt, device, stack)
    return w


class MLP(torch.nn.Module):
    """The parameters of one dense MLP (the reference's ``mlp_init``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        for name, value in mlp_weights(cfg, gen, cfg.d_ff, device).items():
            self.register_parameter(name, _frozen(value))


def activate(up, gate, cfg: ModelConfig):
    """The hidden activation: silu(gate) * up (swiglu), relu(up)² (relu2)
    or tanh-approximate gelu(up) (``jax.nn.gelu``'s default)."""
    if cfg.mlp_act == "swiglu":
        return F.silu(gate) * up
    if cfg.mlp_act == "relu2":
        return torch.square(F.relu(up))
    return F.gelu(up, approximate="tanh")


def apply_mlp(p, x, cfg: ModelConfig):
    cdt = _dtype(cfg.compute_dtype)
    x = x.to(cdt)
    gate = x @ p.w_gate.to(cdt) if cfg.mlp_act == "swiglu" else None
    h = activate(x @ p.w_up.to(cdt), gate, cfg)
    return h @ p.w_down.to(cdt)


# --------------------------------------------------------------------------
# embedding / logits / loss
# --------------------------------------------------------------------------

def embed_tokens(emb, tokens, cfg: ModelConfig):
    """The rows of ``emb`` at ``tokens``, in the compute dtype. A gather
    through ``F.embedding``, whose backward on the card sums each row's
    gradient in a fixed order (indexing's ``index_put_`` accumulates with
    atomics), so that a train step repeats bit for bit."""
    return F.embedding(tokens.long(), emb).to(_dtype(cfg.compute_dtype))


def logits_from_hidden(params, h, cfg: ModelConfig):
    """Logits through the tied embedding or the untied ``unembed``."""
    cdt = _dtype(cfg.compute_dtype)
    return h.to(cdt) @ _unembedding(params, cfg).to(cdt)  # (.., d) @ (d, V)


def mask_padded_vocab(logits, cfg: ModelConfig, fill=NEG_INF):
    """The vocab-padding tail set to ``fill`` (see ModelConfig.vocab_pad_to)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits,
                       torch.tensor(fill, dtype=logits.dtype,
                                    device=logits.device))


def _unembedding(params, cfg: ModelConfig):
    """The (d, Vp) matrix the logits are taken with."""
    return params.embed.t() if cfg.tie_embeddings else params.unembed


def cross_entropy_chunked(params, h, targets, cfg: ModelConfig,
                          chunk: int = 512):
    """Memory-bounded LM loss: the mean NLL over targets >= 0, in chunks
    of the sequence (the batch stays leading), differentiated by autograd.
    Applies ``cfg.logit_softcap``."""
    B, S, d = h.shape
    chunk = min(chunk, S)
    n_chunks = (S + chunk - 1) // chunk
    pad = n_chunks * chunk - S
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int32, device=h.device)
    for c in range(n_chunks):
        hi = h[:, c * chunk:(c + 1) * chunk]
        ti = targets[:, c * chunk:(c + 1) * chunk]
        logits = logits_from_hidden(params, hi, cfg).float()
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        logits = mask_padded_vocab(logits, cfg)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, ti.clamp(min=0).long()[..., None])[..., 0]
        valid = ti >= 0
        tot = tot + torch.where(valid, lse - tgt, 0.0).sum()
        cnt = cnt + valid.sum(dtype=torch.int32)
    return tot / torch.clamp(cnt, min=1)


def _ce_logits(hi, w, vocab_size: int, cdt):
    """One chunk's float32 logits, the vocabulary's padding at NEG_INF."""
    logits = (hi.to(cdt) @ w.to(cdt)).float()
    logits[..., vocab_size:] = NEG_INF
    return logits


def _ce_chunks(h, targets, chunk: int):
    """h and targets padded to whole chunks (padding targets -1)."""
    S = h.shape[1]
    pad = -S % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    return h, targets, (S + pad) // chunk


class _FlashCrossEntropy(torch.autograd.Function):
    """The reference's ``flash_cross_entropy`` (a ``custom_vjp``): the sum
    of token NLLs, saving only each chunk's log-sum-exp; the backward
    recomputes each chunk's logits, so the (S, V) logits never persist."""

    @staticmethod
    def forward(ctx, h, w, targets, vocab_size, chunk, cdt_name):
        cdt = _dtype(cdt_name)
        chunk = min(chunk, h.shape[1])
        hc, tc, n_chunks = _ce_chunks(h, targets, chunk)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for c in range(n_chunks):
            hi = hc[:, c * chunk:(c + 1) * chunk]
            ti = tc[:, c * chunk:(c + 1) * chunk]
            logits = _ce_logits(hi, w, vocab_size, cdt)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, ti.clamp(min=0).long()[..., None])[..., 0]
            tot = tot + torch.where(ti >= 0, lse - tgt, 0.0).sum()
            lses.append(lse)
        ctx.static = (vocab_size, chunk, cdt)
        ctx.save_for_backward(h, w, targets, torch.stack(lses))
        return tot

    @staticmethod
    def backward(ctx, g):
        h, w, targets, lses = ctx.saved_tensors
        vocab_size, chunk, cdt = ctx.static
        B, S, d = h.shape
        hc, tc, n_chunks = _ce_chunks(h, targets, chunk)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dhs = []
        for c in range(n_chunks):
            hi = hc[:, c * chunk:(c + 1) * chunk]
            ti = tc[:, c * chunk:(c + 1) * chunk]
            logits = _ce_logits(hi, w, vocab_size, cdt)
            p = logits.sub_(lses[c][..., None]).exp_()  # softmax
            # dL/dlogits = (p - onehot(target)) * valid * g
            idx = ti.clamp(min=0).long()[..., None]
            dlog = p.scatter_(-1, idx, p.gather(-1, idx) - 1.0)
            dlog = dlog.mul_((ti >= 0).float()[..., None]).mul_(g)
            dlog = dlog.to(cdt)
            dhs.append(dlog @ w.to(cdt).t())
            dw = dw + (hi.to(cdt).reshape(-1, d).t()
                       @ dlog.reshape(-1, dlog.shape[-1])).float()
        dh = torch.cat(dhs, dim=1)[:, :S]
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None, None


def flash_cross_entropy(h, w, targets, vocab_size: int, chunk: int,
                        compute_dtype: str):
    """Sum of token NLLs. h: (B,S,d), w: (d,Vp), targets: (B,S) (-1 =
    pad); logits in ``compute_dtype`` products, chunks of ``chunk``
    positions."""
    return _FlashCrossEntropy.apply(h, w, targets, vocab_size, chunk,
                                    compute_dtype)


def lm_loss_flash(params, h, targets, cfg: ModelConfig, chunk: int = 512):
    """Mean NLL via the recomputing flash cross-entropy (the train step's
    loss)."""
    tot = flash_cross_entropy(h, _unembedding(params, cfg), targets,
                              cfg.vocab_size, chunk, cfg.compute_dtype)
    return tot / torch.clamp((targets >= 0).sum(), min=1)
