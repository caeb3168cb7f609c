"""Architecture registry: one module per architecture the port serves.

A copy of the JAX package's ``configs/__init__.py``: every architecture
of its registry is ported. ``get_config(name)`` returns the full
published config, ``all_configs()`` every architecture's by name;
``get_smoke_config(name)`` a reduced same-family config
for CPU tests (few layers, narrow width, tiny vocab, the same period
structure). ``SHAPES`` are the dry run's input shapes (sequence length,
global batch, step kind) and ``cell_applicable`` says which an
architecture runs.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "mistral_nemo_12b",
    "mistral_large_123b",
    "command_r_35b",
    "nemotron_4_340b",
    "whisper_medium",
    "mamba2_370m",
    "jamba_v01_52b",
    "internvl2_1b",
    "granite_moe_3b_a800m",
    "mixtral_8x22b",
]
PORTED: List[str] = list(ARCH_IDS)


# canonical dashed ids (CLI --arch accepts either form)
def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "")


def _module(name: str):
    arch = canon(name)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def all_configs() -> Dict[str, ModelConfig]:
    """Every architecture's full config, by its id."""
    return {a: get_config(a) for a in ARCH_IDS}


# --------------------------------------------------------------------------
# input shapes assigned to the LM-family pool (seq_len, global_batch, kind)
# --------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def cell_applicable(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k only runs for sub-quadratic archs."""
    if shape_name == "long_500k":
        return cfg.subquadratic
    return True


def smoke_shrink(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Generic reduction preserving family structure."""
    kw = dict(
        n_layers=2 * len(cfg.period),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_head=16,
        d_ff=128,
        vocab_size=256,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
    if cfg.moe_num_experts:
        kw.update(moe_num_experts=4, moe_top_k=min(cfg.moe_top_k, 2), moe_d_ff=64)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=16)
    if cfg.enc_layers:
        kw.update(enc_layers=2, enc_seq=24)
    if cfg.num_patches:
        kw.update(num_patches=8)
    kw.update(overrides)
    return cfg.replace(**kw)
