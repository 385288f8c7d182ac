"""xlstm-350m [ssm]: 24L d=1024 4H d_ff=0 vocab=50304 — alternating
sLSTM + mLSTM blocks [arXiv:2405.04517].

d_ff=0: xLSTM blocks carry their own up/down projections (mLSTM
projection factor 2); there is no separate FFN sublayer.
"""
from repro_torch.configs.base import ModelConfig
import dataclasses


def get_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50_304,
        activation="gelu",
        block_pattern=("mlstm", "slstm"),
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        get_config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        vocab_size=512,
        activation_dtype="float32", remat="none",
    )
