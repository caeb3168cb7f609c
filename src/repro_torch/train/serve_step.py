"""Serving steps of the language-model stack.

* prefill: a full-sequence forward producing the first sampled token (what
  a disaggregated-prefill worker runs);
* decode: one new token against populated KV and SSM caches
  (``decode_step``).

Requests are rows of the batch; serving slots map 1:1 onto rows (a freed
row is refilled by the server loop in :mod:`repro_torch.launch.serve`).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as MDL
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, frontend=None):
        return MDL.prefill_forward(params, tokens, cfg,
                                   frontend_embeds=frontend)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, state, token):
        return MDL.decode_step(params, state, token, cfg)

    return decode_step


def make_decode_state(cfg: ModelConfig, batch: int, ctx: int,
                      dtype=torch.bfloat16, device=None):
    return MDL.init_decode_state(cfg, batch, ctx, dtype, device=device)
