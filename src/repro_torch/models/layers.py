"""Core model layers the ported families need (functions over tensors).

The PyTorch counterpart of the part of the JAX package's
``models/layers.py`` that Mamba-2 uses: dtypes, initialisers, RMSNorm,
the embedding and the tied unembedding. ``cfg.compute_dtype`` is
used inside matrix products; normalisation runs in float32. Attention,
the dense MLP and the chunked losses come with the slices that port their
users.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# --------------------------------------------------------------------------
# init helpers (the JAX package's distributions; a torch.Generator draws
# other numbers than a JAX key, so tests carry weights over instead)
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device=None) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, d: Optional[int] = None,
              device=None) -> torch.nn.ParameterDict:
    """RMSNorm's scale (the ported families' norm; LayerNorm is not yet
    ported)."""
    d = d or cfg.d_model
    scale = torch.ones((d,), dtype=torch.float32, device=device)
    return torch.nn.ParameterDict(
        {"scale": torch.nn.Parameter(scale, requires_grad=False)})


def apply_norm(p, x, cfg: ModelConfig):
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# embedding / logits
# --------------------------------------------------------------------------

def embed_tokens(emb, tokens, cfg: ModelConfig):
    return emb[tokens.long()].to(_dtype(cfg.compute_dtype))


def logits_from_hidden(params, h, cfg: ModelConfig):
    """Logits through the tied embedding (untied unembeddings are not yet
    ported)."""
    cdt = _dtype(cfg.compute_dtype)
    return h.to(cdt) @ params.embed.t().to(cdt)  # (.., d) @ (d, V)


def mask_padded_vocab(logits, cfg: ModelConfig, fill=NEG_INF):
    """The vocab-padding tail set to ``fill`` (see ModelConfig.vocab_pad_to)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits,
                       torch.tensor(fill, dtype=logits.dtype,
                                    device=logits.device))
