"""Mamba2-370m [arXiv:2405.21060; unverified].

48 attention-free SSD layers, d_model=1024 (d_inner=2048, 32 heads of 64),
ssm_state=128, vocab=50280, no MLP (Mamba-2 pure stacks interleave nothing).
O(1) decode state -> long_500k applies.
"""
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.configs import smoke_shrink

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_head=1,
    d_ff=0,
    vocab_size=50280,
    period=(LayerSpec(kind="mamba", mlp="none"),),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    norm="rmsnorm",
    tie_embeddings=True,
    subquadratic=True,
)


def smoke() -> ModelConfig:
    return smoke_shrink(CONFIG)
