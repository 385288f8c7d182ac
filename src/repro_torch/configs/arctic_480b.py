"""arctic-480b [moe]: 35L d=7168 56H (kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual FFN in parallel
[hf:Snowflake/snowflake-arctic-base].

bf16 params + bf16 optimizer moments (ZeRO-sharded over all mesh axes)
— required for the 480B×3-state footprint to fit 16 GB/chip at 256
chips (napkin math in EXPERIMENTS.md §Dry-run).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig
import dataclasses


def get_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32_000,
        activation="silu",
        tie_embeddings=False,
        param_dtype="bfloat16",
        moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864,
                      dense_residual_ff=4864, router_chunk=256),
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        get_config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32,
                      dense_residual_ff=32, router_chunk=16),
        param_dtype="float32", activation_dtype="float32", remat="none",
    )
