"""Architecture registry: ``--arch <id>`` resolution for launchers,
dry-run, tests and benchmarks."""
from __future__ import annotations

import importlib

_MODULES = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "gemma3-27b": "gemma3_27b",
    "gemma-7b": "gemma_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "gemma-2b": "gemma_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "arctic-480b": "arctic_480b",
    "zamba2-7b": "zamba2_7b",
    "chameleon-34b": "chameleon_34b",
    "xlstm-350m": "xlstm_350m",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).get_config()


def get_reduced(arch: str):
    return _module(arch).reduced()
