"""Mixtral-8x22B [arXiv:2401.04088; hf].

56L, d_model=6144, 48 heads (GQA kv=8, head_dim=128), MoE 8 experts top-2
(expert d_ff=16384), vocab=32768, sliding-window attention (4096) as
assigned -> bounded KV -> long_500k applies. bf16 param/optimizer policy
(141B total parameters).
"""
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.configs import smoke_shrink

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=32768,
    period=(LayerSpec(kind="attn", mlp="moe"),),
    mlp_act="swiglu",
    moe_num_experts=8,
    moe_top_k=2,
    moe_d_ff=16384,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    param_dtype="bfloat16",
    subquadratic=True,
)


def smoke() -> ModelConfig:
    return smoke_shrink(CONFIG, sliding_window=32)
