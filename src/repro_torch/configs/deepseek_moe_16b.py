"""deepseek-moe-16b [moe]: 28L d=2048 16H (kv=16) expert d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared experts (fine-grained)
[arXiv:2401.06066; hf].

Deviation (documented): the HF checkpoint's first layer is a dense FFN;
we keep all 28 layers MoE for scan uniformity — active/total param
accounting uses the assigned config as written.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig
import dataclasses


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102_400,
        activation="silu",
        tie_embeddings=False,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                      router_chunk=256),
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        get_config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                      router_chunk=16),
        activation_dtype="float32", remat="none",
    )
