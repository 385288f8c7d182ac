"""qwen2.5-32b [dense]: 64L d=5120 40H (kv=8, GQA) d_ff=27648
vocab=152064 — SwiGLU, QKV bias [hf:Qwen/Qwen2.5-*]."""
from repro_torch.configs.base import ModelConfig
import dataclasses


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=27648,
        vocab_size=152_064,
        activation="silu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        get_config(), n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        activation_dtype="float32", remat="none",
    )
