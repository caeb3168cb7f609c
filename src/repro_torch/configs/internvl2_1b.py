"""InternVL2-1B [arXiv:2404.16821; hf] — InternViT-300M + Qwen2-0.5B backbone.

LM backbone: 24L, d_model=896, 14 heads (GQA kv=2, head_dim=64), d_ff=4864,
vocab=151655, QKV biases (Qwen2), tied embeddings. The ViT frontend is a
STUB: ``input_specs()`` provides 256 precomputed patch embeddings per image,
projected and prepended to the text sequence. Full attention -> long_500k
inapplicable.
"""
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.configs import smoke_shrink

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_head=64,
    d_ff=4864,
    vocab_size=151655,
    period=(LayerSpec(kind="attn", mlp="dense"),),
    mlp_act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    tie_embeddings=True,
    num_patches=256,
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return smoke_shrink(CONFIG)
