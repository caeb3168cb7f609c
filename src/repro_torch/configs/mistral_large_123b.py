"""Mistral-Large-Instruct-2407 (123B) [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L, d_model=12288, 96 heads (GQA kv=8, head_dim=128), d_ff=28672,
vocab=32768. bf16 parameter/optimizer policy (see DESIGN.md §4): at 123B,
f32 master + 2 f32 Adam slots would not fit 256 chips x 16 GB.
"""
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.configs import smoke_shrink

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=32768,
    period=(LayerSpec(kind="attn", mlp="dense"),),
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    param_dtype="bfloat16",
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return smoke_shrink(CONFIG)
