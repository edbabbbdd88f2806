"""Model inputs: concrete synthetic batches (tests, examples) and
shape-only stand-ins on the ``meta`` device (no allocation).

Counterpart of `repro.models.io`.  ``input_specs(cfg, shape)`` says what
each (arch x input shape) cell feeds into a train step, a prefill or a
decode step; where the JAX package returns ``jax.ShapeDtypeStruct``s,
the port returns tensors on the ``meta`` device with the same shapes and
dtypes; a decode step's cache is `repro_torch.models.transformer`'s
``cache_specs`` (the SSM families' state among them).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import frontend, transformer
from repro_torch.models.layers import torch_dtype


def _spec(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_shape(cfg: ModelConfig, batch: int, seq: int) -> Tuple[int, ...]:
    if cfg.num_codebooks:
        return (batch, cfg.num_codebooks, seq)
    return (batch, seq)


def _patch_spec(cfg: ModelConfig, b: int, s: int) -> torch.Tensor:
    n = frontend.num_vision_patches(s)
    return _spec((b, n, cfg.d_model), torch_dtype(cfg.dtype))


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {
        "tokens": _spec(_token_shape(cfg, b, s), torch.int32),
        "labels": _spec(_token_shape(cfg, b, s), torch.int32),
    }
    if cfg.frontend == "vision":
        specs["embeds_override"] = _patch_spec(cfg, b, s)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {
        "tokens": _spec(_token_shape(cfg, b, s), torch.int32)}
    if cfg.frontend == "vision":
        specs["embeds_override"] = _patch_spec(cfg, b, s)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Dict[str, Any]:
    """A decode step's inputs: one new token (or frame) a row and a KV
    (or SSM) cache of seq_len."""
    b, s = shape.global_batch, shape.seq_len
    tok_shape = (b, cfg.num_codebooks) if cfg.num_codebooks else (b,)
    return {"tokens_t": _spec(tok_shape, torch.int32),
            "cache": transformer.cache_specs(cfg, b, s)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


# ---------------------------------------------------------------------------
# Concrete synthetic batches (smoke tests / examples)
# ---------------------------------------------------------------------------


def synthetic_train_batch(cfg: ModelConfig, generator: torch.Generator,
                          batch: int, seq: int) -> Dict[str, Any]:
    """Random tokens (delayed codebook streams for an audio model), the
    labels one step on, and patch embeddings for a VLM, drawn from
    ``generator`` on its device."""
    if cfg.num_codebooks:
        tokens = frontend.encodec_tokens(cfg, generator, batch, seq)
    else:
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=generator, dtype=torch.int32,
                               device=generator.device)
    out = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=-1)}
    if cfg.frontend == "vision":
        out["embeds_override"] = frontend.vision_patch_embeds(
            cfg, generator, batch, seq)
    return out


def synthetic_prompts(cfg: ModelConfig, generator: torch.Generator,
                      batch: int, seq: int) -> Dict[str, Any]:
    b = synthetic_train_batch(cfg, generator, batch, seq)
    out = {"tokens": b["tokens"]}
    if "embeds_override" in b:
        out["embeds_override"] = b["embeds_override"]
    return out
