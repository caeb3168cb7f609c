"""Whisper-medium [arXiv:2212.04356; unverified].

Encoder-decoder: 24 encoder + 24 decoder layers, d_model=1024, 16 MHA heads
(kv=16), d_ff=4096, GELU, vocab=51865, LayerNorm, tied embeddings, biases on
QKV. The conv audio frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (Whisper-native 1500 frames); the decoder
follows each cell's seq_len. Full attention -> long_500k inapplicable.
"""
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.configs import smoke_shrink

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=51865,
    period=(LayerSpec(kind="attn", mlp="dense"),),
    mlp_act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    qkv_bias=True,
    enc_layers=24,
    enc_seq=1500,
    subquadratic=False,
)


def smoke() -> ModelConfig:
    return smoke_shrink(CONFIG)
