"""Core model layers (functions over tensors).

The PyTorch counterpart of the JAX package's ``models/layers.py``: dtypes,
initialisers, RMSNorm and LayerNorm, rotary embeddings, attention (causal,
bidirectional and cross, as a chunked online-softmax forward with the
reference's recomputing backward; single-token decode against a KV
cache), the dense MLPs, the embedding, the tied or untied unembedding and
the two cross-entropies (chunked, and the flash one with its recomputing
backward). ``cfg.compute_dtype`` is used inside the projections;
normalisation, softmax and RoPE run in float32, and so do the attention
score and PV products unless ``cfg.attn_bf16``. Attention's queries and
outputs pass the reference's sharding constraints
(:mod:`repro_torch.train.sharding`; identities outside its ``mesh_axes``).

Parameters are built frozen (``requires_grad=False``), so that serving
records no autograd graph; the train step turns gradients on for the
model it trains (``repro_torch.train.train_step.init_state``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.config import ModelConfig
from repro_torch.train import sharding as SH

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
    cos = SH.like(torch.cos(ang)[..., None, :], x)  # (..., S, 1, d/2)
    sin = SH.like(torch.sin(ang)[..., None, :], x)
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
    q = xq.to(cdt) @ SH.gather_fsdp(p.wq).to(cdt)
    k = xkv.to(cdt) @ SH.gather_fsdp(p.wk).to(cdt)
    v = xkv.to(cdt) @ SH.gather_fsdp(p.wv).to(cdt)
    if cfg.qkv_bias:
        q = q + p.bq.to(cdt)
        k = k + p.bk.to(cdt)
        v = v + p.bv.to(cdt)
    q = _split_heads(q, cfg.n_heads, cfg.d_head)
    k = _split_heads(k, cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(v, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def _split_heads(t, n_heads: int, d_head: int):
    """(B, S, n_heads·d_head) -> (B, S, n_heads, d_head). A DTensor whose
    last dim a mesh dim splits into parts that are not whole heads is
    gathered on that mesh dim first."""
    if isinstance(t, DTensor):
        keep = tuple(Replicate() if p == Shard(2)
                     and n_heads % t.device_mesh.size(i) else p
                     for i, p in enumerate(t.placements))
        if keep != tuple(t.placements):
            t = t.redistribute(t.device_mesh, keep)
    return t.reshape(t.shape[0], t.shape[1], n_heads, d_head)


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
                  scale, q_offset=0):
    """Chunk ``c``'s (keys ``sl``) scaled scores (B, Hkv, rep, Sq, chunk)
    float32 from the grouped queries and the chunk's keys kb (B, Hkv, dh,
    chunk), ``NEG_INF`` where the key is masked."""
    B, Hkv = qg.shape[0], qg.shape[1]
    s = (qg @ kb).mul_(scale).view(B, Hkv, rep, Sq, chunk)
    q_pos = q_offset + torch.arange(Sq, device=qg.device)
    k_pos = c * chunk + torch.arange(chunk, device=qg.device)
    mask = _chunk_mask(kvv[:, sl], k_pos, q_pos, causal, window)
    return s.masked_fill_(~mask[:, None, None], NEG_INF)


def _flash_fwd(q, kp, vp, kvv, causal: bool, window: int, chunk: int,
               mm_bf16: bool, q_offset: int = 0):
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
                          scale, q_offset)
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
               chunk: int, mm_bf16: bool, q_offset: int = 0):
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
                          scale, q_offset)
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
    def forward(ctx, q, kp, vp, kvv, causal, window, chunk, mm_bf16,
                q_offset=0):
        o, lse = _flash_fwd(q, kp, vp, kvv, causal, window, chunk, mm_bf16,
                            q_offset)
        ctx.static = (causal, window, chunk, mm_bf16, q_offset)
        ctx.save_for_backward(q, kp, vp, kvv, o, lse)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, kp, vp, kvv, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(do, q, kp, vp, kvv, o, lse, *ctx.static)
        return (dq.to(q.dtype), dk.to(kp.dtype), dv.to(vp.dtype), None, None,
                None, None, None, None)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0,
                      kv_valid: Optional[torch.Tensor] = None,
                      chunk: int = KV_CHUNK,
                      matmul_bf16: bool = False,
                      q_offset: int = 0) -> torch.Tensor:
    """Flash attention: online softmax over KV chunks, with the
    reference's recomputing backward. q: (B, Sq, H, dh); k, v: (B, Skv,
    Hkv, dh); kv_valid: optional (B, Skv) bool. Keys are padded to a
    multiple of the chunk and masked; masked scores are ``NEG_INF``, not
    -inf, so a row with no valid key averages the values (as the
    reference does). ``q_offset``: the position of the first query (the
    keys start at 0). Returns (B, Sq, H, dh) in q's dtype. DTensors go
    through :func:`_attention_mesh`."""
    if isinstance(q, DTensor):
        return _attention_mesh(q, k, v, causal=causal, window=window,
                               kv_valid=kv_valid, chunk=chunk,
                               matmul_bf16=matmul_bf16)
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
                                 int(chunk), bool(matmul_bf16),
                                 int(q_offset))


def _attention_mesh(q, k, v, *, causal: bool, window: int, kv_valid,
                    chunk: int, matmul_bf16: bool):
    """Attention of DTensors through ``local_map``: each rank attends with
    its own rows. A mesh dim that shards q's batch shards k and v's too;
    one that shards q's heads gives each rank its query heads and the KV
    heads they read (k and v split alike where the KV heads divide the
    dim, else whole and sliced here); one that shards q's sequence
    (context-parallel) gives each rank its queries at their positions
    against whole k and v. Every other mesh dim is replicated first."""
    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    rep = H // Hkv
    roles = []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        Hl = H // n  # query heads a rank holds when the dim splits them
        if p == Shard(0):
            roles.append("batch")
        elif p == Shard(2) and Hkv % n == 0 and Hl % rep == 0:
            roles.append("heads")
        elif p == Shard(2) and (Hl % rep == 0 or rep % Hl == 0):
            roles.append("heads_kv_whole")
        elif p == Shard(1):
            roles.append("seq")
        else:
            roles.append(None)

    def lay(for_role):
        return tuple(for_role.get(r, Replicate()) for r in roles)

    q_pl = lay({"batch": Shard(0), "heads": Shard(2),
                "heads_kv_whole": Shard(2), "seq": Shard(1)})
    kv_pl = lay({"batch": Shard(0), "heads": Shard(2)})
    # where k and v are whole, a rank's gradient sums its queries' part
    dkv_pl = lay({"batch": Shard(0), "heads": Shard(2),
                  "heads_kv_whole": Partial(), "seq": Partial()})
    valid_pl = lay({"batch": Shard(0)})

    def local(ql, kl, vl, valid):
        q_offset = 0
        for i, r in enumerate(roles):
            if r == "seq":
                q_offset += mesh.get_local_rank(i) * ql.shape[1]
            elif r == "heads_kv_whole":  # this rank's query heads' KV heads
                h0 = mesh.get_local_rank(i) * ql.shape[2]
                lo, hi = h0 // rep, (h0 + ql.shape[2] - 1) // rep + 1
                kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return chunked_attention(ql, kl, vl, causal=causal, window=window,
                                 kv_valid=valid, chunk=chunk,
                                 matmul_bf16=matmul_bf16, q_offset=q_offset)

    fn = local_map(local, out_placements=(q_pl,),
                   in_placements=(q_pl, kv_pl, kv_pl,
                                  None if kv_valid is None else valid_pl),
                   in_grad_placements=(q_pl, dkv_pl, dkv_pl,
                                       None if kv_valid is None
                                       else valid_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v, kv_valid)


def attention_train(p, x, cfg: ModelConfig, positions=None):
    """Causal self-attention over a full sequence (training / prefill).
    Returns (out (B,S,d), (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = SH.constrain_attn_q(q)
    o = chunked_attention(q, k, v, causal=True, window=cfg.sliding_window,
                          matmul_bf16=cfg.attn_bf16)
    o = SH.constrain_attn_out(o)
    cdt = _dtype(cfg.compute_dtype)
    o = o.reshape(B, S, cfg.d_qkv).to(cdt) @ SH.gather_fsdp(p.wo).to(cdt)
    return SH.reduce_partial(o), (k, v)


def attention_bidir(p, x, cfg: ModelConfig):
    """Bidirectional self-attention (the encoder), with RoPE on the frames
    as the reference applies it."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = SH.constrain_attn_q(q)
    o = chunked_attention(q, k, v, causal=False, matmul_bf16=cfg.attn_bf16)
    o = SH.constrain_attn_out(o)
    cdt = _dtype(cfg.compute_dtype)
    return SH.reduce_partial(
        o.reshape(B, S, cfg.d_qkv).to(cdt) @ SH.gather_fsdp(p.wo).to(cdt))


def attention_cross(p, x, enc_out, cfg: ModelConfig):
    """Cross-attention from the decoder's x to the encoder's output (no
    RoPE; K and V with their biases)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, enc_out, cfg)
    q = SH.constrain_attn_q(q)
    o = chunked_attention(q, k, v, causal=False, matmul_bf16=cfg.attn_bf16)
    o = SH.constrain_attn_out(o)
    cdt = _dtype(cfg.compute_dtype)
    return SH.reduce_partial(
        o.reshape(B, S, cfg.d_qkv).to(cdt) @ SH.gather_fsdp(p.wo).to(cdt))


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
    o = o.reshape(B, 1, cfg.d_qkv).to(cdt) @ SH.gather_fsdp(p.wo).to(cdt)
    return SH.reduce_partial(o), {"k": ck, "v": cv, "pos": pos + 1}


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
    gate = x @ SH.gather_fsdp(p.w_gate).to(cdt) if cfg.mlp_act == "swiglu" else None
    h = activate(x @ SH.gather_fsdp(p.w_up).to(cdt), gate, cfg)
    return SH.reduce_partial(h @ SH.gather_fsdp(p.w_down).to(cdt))


# --------------------------------------------------------------------------
# embedding / logits / loss
# --------------------------------------------------------------------------

def embed_tokens(emb, tokens, cfg: ModelConfig):
    """The rows of ``emb`` at ``tokens``, in the compute dtype. A gather
    through ``F.embedding``, whose backward on the card sums each row's
    gradient in a fixed order (indexing's ``index_put_`` accumulates with
    atomics), so that a train step repeats bit for bit. A DTensor table
    takes the vocab-parallel lookup (:func:`_embed_mesh`)."""
    if isinstance(emb, DTensor):
        return _embed_mesh(emb, tokens).to(_dtype(cfg.compute_dtype))
    return F.embedding(tokens.long(), emb).to(_dtype(cfg.compute_dtype))


class _VocabParallelEmbedding(torch.autograd.Function):
    """Rows of a table that holds the vocabulary ids from ``offset`` on
    (the other ids on the other ranks of ``group``): each rank looks up
    the tokens it holds, zero elsewhere, and the group sums the rows."""

    @staticmethod
    def forward(ctx, tokens, emb, offset, group):
        idx = tokens.long() - offset
        mine = (idx >= 0) & (idx < emb.shape[0])
        idx = torch.where(mine, idx, 0)
        ctx.save_for_backward(idx, mine)
        ctx.n_rows = emb.shape[0]
        out = F.embedding(idx, emb) * mine[..., None]
        return funcol.all_reduce(out, "sum", group)

    @staticmethod
    def backward(ctx, g):
        idx, mine = ctx.saved_tensors
        g = g * mine[..., None]
        return None, torch.ops.aten.embedding_dense_backward(
            g, idx, ctx.n_rows, -1, False), None, None


def _vocab_parallel(rows_of, table, vocab_dim_of_table: int):
    """How a row-local op over a vocabulary table maps onto the mesh:
    the mesh dims that shard ``rows_of``'s batch (its dim 0) are "batch",
    the first other dim (of size > 1) that shards the table's vocabulary
    dim is "vocab". Returns (lay, the vocab mesh dim or None), where
    ``lay(on_batch, on_vocab)`` gives one placement a mesh dim,
    Replicate() on the others."""
    mesh = table.device_mesh
    roles, vocab_dim = [], None
    for i, (pr, pt) in enumerate(zip(rows_of.placements, table.placements)):
        if pr == Shard(0):
            roles.append("batch")
        elif (pt == Shard(vocab_dim_of_table) and vocab_dim is None
              and mesh.size(i) > 1):
            roles.append("vocab")
            vocab_dim = i
        else:
            roles.append(None)

    def lay(on_batch, on_vocab):
        return tuple(on_batch if r == "batch" else on_vocab if r == "vocab"
                     else Replicate() for r in roles)

    return lay, vocab_dim


def _embed_mesh(emb, tokens):
    """The lookup of DTensors through ``local_map``: the mesh dims that
    shard the tokens' batch give each rank its rows; the first other one
    that shards the table's vocabulary splits the lookup as
    :class:`_VocabParallelEmbedding` does; the table's other dims are
    gathered first."""
    mesh = emb.device_mesh
    lay, vocab_dim = _vocab_parallel(tokens, emb, 0)
    rows = lay(Shard(0), Replicate())

    def local(tl, el):
        if vocab_dim is None:
            return F.embedding(tl.long(), el)
        return _VocabParallelEmbedding.apply(
            tl, el, mesh.get_local_rank(vocab_dim) * el.shape[0],
            mesh.get_group(vocab_dim))

    fn = local_map(local, out_placements=(rows,),
                   in_placements=(rows, lay(Replicate(), Shard(0))),
                   in_grad_placements=(rows, lay(Partial(), Shard(0))),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(tokens, emb)


def logits_from_hidden(params, h, cfg: ModelConfig):
    """Logits through the tied embedding or the untied ``unembed``."""
    cdt = _dtype(cfg.compute_dtype)
    return h.to(cdt) @ SH.gather_fsdp(_unembedding(params, cfg)).to(cdt)  # (.., d) @ (d, V)


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


def _ce_logits(hi, w, vocab_size: int, cdt, offset: int = 0):
    """One chunk's float32 logits over the vocabulary columns of ``w``
    (the first one at id ``offset``), the vocabulary's padding at
    NEG_INF."""
    logits = (hi.to(cdt) @ w.to(cdt)).float()
    logits[..., max(vocab_size - offset, 0):] = NEG_INF
    return logits


def _ce_chunks(h, targets, chunk: int):
    """h and targets padded to whole chunks (padding targets -1)."""
    S = h.shape[1]
    pad = -S % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    return h, targets, (S + pad) // chunk


def _vocab_sum(x, group, op: str = "sum"):
    """``x`` reduced over the ranks that share the vocabulary (itself
    without a group)."""
    return x if group is None else funcol.all_reduce(x, op, group)


class _FlashCrossEntropy(torch.autograd.Function):
    """The reference's ``flash_cross_entropy`` (a ``custom_vjp``): the sum
    of token NLLs, saving only each chunk's log-sum-exp; the backward
    recomputes each chunk's logits, so the (S, V) logits never persist.

    ``vocab``: None, or (offset, group) when ``w`` holds the vocabulary
    columns from ``offset`` on and the other columns lie on the other
    ranks of ``group`` (Megatron's vocab-parallel cross-entropy: the
    log-sum-exp, the target's logit and dh are summed over the group).
    """

    @staticmethod
    def forward(ctx, h, w, targets, vocab_size, chunk, cdt_name,
                vocab=None):
        cdt = _dtype(cdt_name)
        offset, group = vocab or (0, None)
        chunk = min(chunk, h.shape[1])
        hc, tc, n_chunks = _ce_chunks(h, targets, chunk)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for c in range(n_chunks):
            hi = hc[:, c * chunk:(c + 1) * chunk]
            ti = tc[:, c * chunk:(c + 1) * chunk]
            logits = _ce_logits(hi, w, vocab_size, cdt, offset)
            if group is None:
                lse = torch.logsumexp(logits, dim=-1)
                tgt = logits.gather(-1, ti.clamp(min=0).long()[..., None])[
                    ..., 0]
            else:
                m = _vocab_sum(logits.amax(dim=-1), group, "max")
                se = _vocab_sum((logits - m[..., None]).exp().sum(dim=-1),
                                group)
                lse = m + torch.log(se)
                idx = ti.long() - offset
                mine = (idx >= 0) & (idx < logits.shape[-1])
                tgt = logits.gather(
                    -1, idx.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
                tgt = _vocab_sum(torch.where(mine, tgt, 0.0), group)
            tot = tot + torch.where(ti >= 0, lse - tgt, 0.0).sum()
            lses.append(lse)
        ctx.static = (vocab_size, chunk, cdt, offset, group)
        ctx.save_for_backward(h, w, targets, torch.stack(lses))
        return tot

    @staticmethod
    def backward(ctx, g):
        h, w, targets, lses = ctx.saved_tensors
        vocab_size, chunk, cdt, offset, group = ctx.static
        B, S, d = h.shape
        Vl = w.shape[-1]
        hc, tc, n_chunks = _ce_chunks(h, targets, chunk)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dhs = []
        for c in range(n_chunks):
            hi = hc[:, c * chunk:(c + 1) * chunk]
            ti = tc[:, c * chunk:(c + 1) * chunk]
            logits = _ce_logits(hi, w, vocab_size, cdt, offset)
            p = logits.sub_(lses[c][..., None]).exp_()  # softmax
            # dL/dlogits = (p - onehot(target)) * valid * g
            local = ti.long() - offset
            idx = local.clamp(0, Vl - 1)[..., None]
            hit = ((local >= 0) & (local < Vl)).float()[..., None]
            dlog = p.scatter_(-1, idx, p.gather(-1, idx) - hit)
            dlog = dlog.mul_((ti >= 0).float()[..., None]).mul_(g)
            dlog = dlog.to(cdt)
            dhs.append(_vocab_sum(dlog @ w.to(cdt).t(), group))
            dw = dw + (hi.to(cdt).reshape(-1, d).t()
                       @ dlog.reshape(-1, dlog.shape[-1])).float()
        dh = torch.cat(dhs, dim=1)[:, :S]
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None, None, None


def _flash_ce_mesh(h, w, targets, vocab_size: int, chunk: int,
                   compute_dtype: str):
    """The sharded loss: each rank takes its rows of h and targets (the
    mesh dims that shard h's batch) and its vocabulary columns of w (the
    first other mesh dim that shards them); every other mesh dim sees
    both whole. Returns the DTensor sum, partial over the batch's dims."""
    mesh = h.device_mesh
    lay, vocab_dim = _vocab_parallel(h, w, 1)
    rows = lay(Shard(0), Replicate())

    def local(hl, wl, tl):
        vocab = None
        if vocab_dim is not None:
            vocab = (mesh.get_local_rank(vocab_dim) * wl.shape[-1],
                     mesh.get_group(vocab_dim))
        return _FlashCrossEntropy.apply(hl, wl, tl, vocab_size, chunk,
                                        compute_dtype, vocab)

    fn = local_map(local, out_placements=(lay(Partial(), Replicate()),),
                   in_placements=(rows, lay(Replicate(), Shard(1)), rows),
                   in_grad_placements=(rows, lay(Partial(), Shard(1)), rows),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(h, w, targets)


def flash_cross_entropy(h, w, targets, vocab_size: int, chunk: int,
                        compute_dtype: str):
    """Sum of token NLLs. h: (B,S,d), w: (d,Vp), targets: (B,S) (-1 =
    pad); logits in ``compute_dtype`` products, chunks of ``chunk``
    positions. DTensors take the vocab-parallel loss (see
    :class:`_FlashCrossEntropy`) through ``local_map``."""
    if isinstance(h, DTensor):
        return _flash_ce_mesh(h, w, targets, vocab_size, chunk,
                              compute_dtype)
    return _FlashCrossEntropy.apply(h, w, targets, vocab_size, chunk,
                                    compute_dtype)


def lm_loss_flash(params, h, targets, cfg: ModelConfig, chunk: int = 512):
    """Mean NLL via the recomputing flash cross-entropy (the train step's
    loss)."""
    tot = flash_cross_entropy(h, _unembedding(params, cfg), targets,
                              cfg.vocab_size, chunk, cfg.compute_dtype)
    return tot / torch.clamp((targets >= 0).sum(), min=1)
