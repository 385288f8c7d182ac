"""gemma-7b [dense]: 28L d=3072 16H (kv=16, MHA) d_ff=24576 vocab=256000
— GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""
from repro_torch.configs.base import ModelConfig
import dataclasses


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256_000,
        activation="geglu",
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        get_config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512,
        activation_dtype="float32", remat="none",
    )
