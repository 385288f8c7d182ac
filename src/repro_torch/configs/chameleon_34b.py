"""chameleon-34b [vlm]: 48L d=8192 64H (kv=8) d_ff=22016 vocab=65536 —
early-fusion, VQ image tokens, QK-norm [arXiv:2405.09818].

The VQ tokenizer is the modality frontend and is a STUB per the
assignment: ``input_specs`` provides precomputed patch/token embeddings
(B, S, d_model); text/image tokens share the 65536 vocab.
"""
from repro_torch.configs.base import ModelConfig
import dataclasses


def get_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=65_536,
        activation="silu",
        qk_norm=True,
        tie_embeddings=False,
        frontend="vision",
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        get_config(), n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        activation_dtype="float32", remat="none",
    )
