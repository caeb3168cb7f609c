"""Cohere Command-R v01 (35B) [hf:CohereForAI/c4ai-command-r-v01; unverified].

40L, d_model=8192, 64 heads (GQA kv=8), d_ff=22528, vocab=256000, no biases,
LayerNorm (Cohere-style), tied embeddings, rope_theta=8e6.
"""
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.configs import smoke_shrink

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22528,
    vocab_size=256_000,
    period=(LayerSpec(kind="attn", mlp="dense"),),
    mlp_act="swiglu",
    rope_theta=8_000_000.0,
    norm="layernorm",
    tie_embeddings=True,
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return smoke_shrink(CONFIG)
