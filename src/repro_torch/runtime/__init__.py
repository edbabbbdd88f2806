"""Runtime of the port: engines, KV managers, sampling, sessions.

Attribute access is lazy (PEP 562), as in the JAX package: the pipeline
imports the dependency-free `repro_torch.runtime.session` at import time,
and importing the engine here would close a cycle.
"""
from repro_torch.runtime.session import (GenerationParams, Session,
                                         SessionState)

__all__ = ["BlockTableManager", "BucketLadder", "ContinuousEngine",
           "GenerationParams", "InferenceEngine", "KVSlabManager",
           "PrefixMatch", "RadixPrefixCache", "Session", "SessionState",
           "kv_bytes_per_token", "ssm_state_bytes"]

_LAZY = {
    "BlockTableManager": ("repro_torch.runtime.kv_cache",
                          "BlockTableManager"),
    "BucketLadder": ("repro_torch.runtime.bucketing", "BucketLadder"),
    "ContinuousEngine": ("repro_torch.runtime.engine", "ContinuousEngine"),
    "InferenceEngine": ("repro_torch.runtime.engine", "InferenceEngine"),
    "KVSlabManager": ("repro_torch.runtime.kv_cache", "KVSlabManager"),
    "PrefixMatch": ("repro_torch.runtime.prefix_cache", "PrefixMatch"),
    "RadixPrefixCache": ("repro_torch.runtime.prefix_cache",
                         "RadixPrefixCache"),
    "kv_bytes_per_token": ("repro_torch.runtime.kv_cache",
                           "kv_bytes_per_token"),
    "ssm_state_bytes": ("repro_torch.runtime.kv_cache", "ssm_state_bytes"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(__all__)
