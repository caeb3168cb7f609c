"""Jamba-v0.1 (52B total, MoE) [arXiv:2403.19887; hf].

32 layers arranged in 8-layer periods: Mamba:attention = 7:1 (one attention
layer at position 4 of each period), MoE every other layer (16 experts,
top-2, expert d_ff=14336). d_model=4096, 32 q heads / 8 kv heads.
SSM state per Jamba (Mamba-1 d_state=16) — realized with the SSD block, see
DESIGN.md §9. Hybrid -> long_500k applies (attention KV is 4 layers only).
"""
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.configs import smoke_shrink

_m_mlp = LayerSpec(kind="mamba", mlp="dense")
_m_moe = LayerSpec(kind="mamba", mlp="moe")
_a_mlp = LayerSpec(kind="attn", mlp="dense")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    # positions 0..7; attention at 4; MoE on odd positions (every other layer)
    period=(_m_mlp, _m_moe, _m_mlp, _m_moe, _a_mlp, _m_moe, _m_mlp, _m_moe),
    mlp_act="swiglu",
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    param_dtype="bfloat16",
    subquadratic=True,
)


def smoke() -> ModelConfig:
    return smoke_shrink(CONFIG, n_layers=8)  # one full period
