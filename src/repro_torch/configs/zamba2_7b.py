"""zamba2-7b [hybrid]: 81L d=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone + *shared-weight* attention block applied
after every 6 SSM layers [arXiv:2411.15242].

81 = 13 groups × 6 mamba2 layers (each followed by the shared attn+MLP
block) + 3 tail mamba2 layers.  The shared block's parameters exist
once; d_ff applies to its MLP (mamba2 layers carry no FFN).
"""
from repro_torch.configs.base import ModelConfig
import dataclasses


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32_000,
        activation="silu",
        ssm_state=64,
        block_pattern=("mamba2",),
        shared_attn_period=6,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        get_config(), n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, ssm_state=16,
        ssm_head_dim=16, shared_attn_period=2,
        activation_dtype="float32", remat="none",
    )
