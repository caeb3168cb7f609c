"""Mistral-Nemo-Base-2407 (12B) [hf:mistralai/Mistral-Nemo-Base-2407; hf].

40L, d_model=5120, 32 query heads with GQA kv=8, head_dim=128 (explicit in
the HF config: q-proj is 4096-wide, not d_model), d_ff=14336, vocab=131072,
128k context, rope_theta=1e6. Full attention -> long_500k inapplicable.
"""
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.configs import smoke_shrink

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    period=(LayerSpec(kind="attn", mlp="dense"),),
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return smoke_shrink(CONFIG)
