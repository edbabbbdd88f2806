"""Registry of the architectures the port serves (``get_config``): every
architecture of the JAX package's registry, in its order."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (ALL_SHAPES, SHAPES, SMOKE_SHAPE,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      SSMConfig, reduce_for_smoke,
                                      shapes_for)

_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "llama3-405b": "llama3_405b",
    "internlm2-1.8b": "internlm2_1_8b",
    "starcoder2-15b": "starcoder2_15b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "musicgen-large": "musicgen_large",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ALL_SHAPES", "ARCH_IDS", "SHAPES", "SMOKE_SHAPE", "ModelConfig",
           "MoEConfig", "SSMConfig", "ShapeConfig", "all_configs", "get_config",
           "get_smoke_config", "reduce_for_smoke", "shapes_for"]
