"""gemma3-27b [dense]: 62L d=5376 32H (kv=16) d_ff=21504 vocab=262144 —
5:1 local:global attention, 128k context [hf:google/gemma-3-*].

Sliding window 1024 on local layers; every 6th layer is global.
head_dim=128 (so H·hd ≠ d_model, as in the real checkpoint), GeGLU,
QK-norm.  RoPE theta: single 10k base (the real model uses 1M on global
layers — per-kind theta is a one-line extension, noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig
import dataclasses


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262_144,
        activation="geglu",
        qk_norm=True,
        sliding_window=1024,
        local_global_period=6,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        get_config(), n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, sliding_window=16,
        local_global_period=3, activation_dtype="float32", remat="none",
    )
