"""Registry of the architectures the port serves (``get_config``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduce_for_smoke

_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
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


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "get_smoke_config",
           "reduce_for_smoke"]
