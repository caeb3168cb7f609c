"""Nemotron-4-340B [arXiv:2402.16819 (Nemotron-4 15B report for the family),
340B config unverified].

96L, d_model=18432, 96 heads (GQA kv=8, head_dim=192), d_ff=73728,
squared-ReLU MLP (no gating), vocab=256000. bf16 param/optimizer policy
(340B cannot hold f32 Adam on 256 chips).
"""
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.configs import smoke_shrink

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_head=192,
    d_ff=73728,
    vocab_size=256_000,
    period=(LayerSpec(kind="attn", mlp="dense"),),
    mlp_act="relu2",
    rope_theta=10_000.0,
    norm="layernorm",
    param_dtype="bfloat16",
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return smoke_shrink(CONFIG, d_head=24)  # keep the non-power-of-2 head_dim flavor
