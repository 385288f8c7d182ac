"""seamless-m4t-large-v2 [audio]: 24L (per stack) d=1024 16H (kv=16)
d_ff=8192 vocab=256206 — encoder-decoder, multimodal
[arXiv:2308.11596; hf].

The audio frontend is a STUB per the assignment: ``input_specs`` feeds
precomputed frame embeddings (B, S_enc, d_model) to the encoder.  "24L"
describes each stack (the HF checkpoint has 24 encoder + 24 decoder
layers).  Real model uses ReLU FFNs + learned positions; we use gelu +
RoPE (framework-uniform, FLOP/byte-equivalent — DESIGN.md §2).
"""
from repro_torch.configs.base import ModelConfig
import dataclasses


def get_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=24,
        encoder_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=256_206,
        activation="gelu",
        frontend="audio",
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        get_config(), n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=512,
        activation_dtype="float32", remat="none",
    )
