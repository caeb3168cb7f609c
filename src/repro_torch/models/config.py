"""Architecture configuration for the unified model zoo.

A copy of the JAX package's ``models/config.py`` (it imports no JAX; the
port keeps its own copy, and ``tests/test_torch_fabric.py`` checks that
the two give the same configurations).

Every assigned architecture is expressed as a single ``ModelConfig``. The
layer stack is described by a *period*: a short tuple of ``LayerSpec`` that is
repeated ``n_layers / len(period)`` times. Homogeneous transformers have a
period of length 1; Jamba has a period of length 8 (one attention layer per
eight, MoE every other layer). The trainer scans over periods so the traced
HLO contains one period regardless of depth.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeated layer period."""

    kind: str = "attn"  # "attn" | "mamba"
    mlp: str = "dense"  # "dense" | "moe" | "none"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # Layer period (see module docstring). Default: single attention layer.
    period: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # --- MLP ---
    mlp_act: str = "swiglu"  # swiglu | relu2 | gelu
    use_bias: bool = False
    qkv_bias: bool = False

    # --- attention ---
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # --- encoder-decoder ---
    enc_layers: int = 0
    enc_seq: int = 0  # fixed encoder length (e.g. Whisper 1500 frames)

    # --- VLM ---
    num_patches: int = 0  # prepended precomputed patch embeddings

    # --- numerics / distribution policy ---
    param_dtype: str = "float32"  # big archs use bfloat16 (see configs/)
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # "full": save only layer boundaries (recompute everything in bwd);
    # "dots": save matmul outputs, recompute elementwise chains — the right
    # point when HBM has headroom (see EXPERIMENTS.md §Perf).
    remat_policy: str = "full"
    # bf16 operands (f32 accumulation) for the flash-attention score/PV
    # matmuls — halves the dominant per-chunk attention traffic; softmax
    # statistics stay f32 (see EXPERIMENTS.md §Perf nemotron iteration 3).
    attn_bf16: bool = False
    # Embedding tables are padded to a multiple of this so the vocab dim
    # shards on the 16-wide model axis (padded logits are masked in the
    # loss / argmax). Standard TPU practice; 0 disables.
    vocab_pad_to: int = 256
    # Whether attention is sub-quadratic in context (bounded KV / SSM state),
    # i.e. whether the long_500k cell applies (see DESIGN.md §5).
    subquadratic: bool = False

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ----- derived -----
    @property
    def padded_vocab(self) -> int:
        if not self.vocab_pad_to:
            return self.vocab_size
        m = self.vocab_pad_to
        return -(-self.vocab_size // m) * m

    @property
    def d_qkv(self) -> int:
        return self.n_heads * self.d_head

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.period) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by period "
            f"{len(self.period)}"
        )
        return self.n_layers // len(self.period)

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline + reporting)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for spec in self.period:
            p = 0
            if spec.kind == "attn":
                p += d * self.d_qkv  # wq
                p += 2 * d * (self.n_kv_heads * self.d_head)  # wk, wv
                p += self.d_qkv * d  # wo
            elif spec.kind == "mamba":
                di, ds = self.ssm_d_inner, self.ssm_state
                p += d * (2 * di + 2 * ds + self.ssm_n_heads)  # in_proj
                p += self.ssm_conv * (di + 2 * ds)  # conv
                p += di * d  # out_proj
                p += 2 * self.ssm_n_heads  # A_log, D
            if spec.mlp == "dense":
                n_mats = 3 if self.mlp_act == "swiglu" else 2
                p += n_mats * d * ff
            elif spec.mlp == "moe":
                n_mats = 3 if self.mlp_act == "swiglu" else 2
                p += self.moe_num_experts * n_mats * d * self.moe_d_ff
                p += d * self.moe_num_experts  # router
            p += 2 * d  # two norms
            total += p * self.n_periods
        if self.enc_layers:
            # encoder self-attn+mlp, plus decoder cross-attention stacks.
            enc = self.enc_layers * (
                4 * d * self.d_qkv + 2 * d * ff + 2 * d
            )
            cross = self.n_layers * (4 * d * self.d_qkv + d)
            total += enc + cross
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of the experts)."""
        if not self.moe_num_experts:
            return self.param_count()
        d = self.d_model
        n_mats = 3 if self.mlp_act == "swiglu" else 2
        per_expert = n_mats * d * self.moe_d_ff
        n_moe_layers = (
            sum(1 for s in self.period if s.mlp == "moe") * self.n_periods
        )
        inactive = n_moe_layers * (self.moe_num_experts - self.moe_top_k) * per_expert
        return self.param_count() - inactive
