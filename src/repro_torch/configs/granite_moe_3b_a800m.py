"""Granite-3.0 MoE 3B-a800M [hf:ibm-granite family; hf].

32L, d_model=1536, 24 heads (GQA kv=8, head_dim=64), MoE on every layer:
40 experts, top-8, expert d_ff=512, vocab=49155, tied embeddings.
"""
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.configs import smoke_shrink

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,
    period=(LayerSpec(kind="attn", mlp="moe"),),
    mlp_act="swiglu",
    moe_num_experts=40,
    moe_top_k=8,
    moe_d_ff=512,
    rope_theta=10_000.0,
    norm="rmsnorm",
    tie_embeddings=True,
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return smoke_shrink(CONFIG, moe_num_experts=8, moe_top_k=4)
