"""gemma-2b [dense]: 18L d=2048 8H (kv=1, MQA) d_ff=16384 vocab=256000 —
GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""
from repro_torch.configs.base import ModelConfig
import dataclasses


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256_000,
        activation="geglu",
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        get_config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=512,
        activation_dtype="float32", remat="none",
    )
