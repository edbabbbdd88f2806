"""Stub modality front ends: precomputed frame and patch embeddings (the
transformer backbone is the system under test).

Counterpart of `repro.models.frontend`:

- vision (Qwen2-VL): :func:`vision_patch_embeds` draws patch embeddings
  for a square grid that takes the first slots of the sequence
  (`repro_torch.models.transformer.embed_inputs`), with M-RoPE positions
  from `repro_torch.models.layers.positions_for`;
- audio (MusicGen): EnCodec codebook streams with the MusicGen *delay
  pattern* applied across codebooks.

Random draws come from a ``torch.Generator``; the JAX package draws from
a ``jax.random`` key, so the two give different numbers from one seed.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype


def num_vision_patches(seq_len: int) -> int:
    """Stub policy: image prefix occupies ~1/8 of the sequence, grid-aligned."""
    n = max(seq_len // 8, 4)
    g = int(n ** 0.5)
    return max(g * g, 4)


def vision_patch_embeds(cfg: ModelConfig, generator: torch.Generator,
                        batch: int, seq_len: int) -> torch.Tensor:
    """Precomputed ViT patch embeddings (stub): (B, N_img, d_model) in the
    config's dtype on ``generator``'s device."""
    n = num_vision_patches(seq_len)
    x = torch.randn((batch, n, cfg.d_model), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return x.to(torch_dtype(cfg.dtype)) * 0.02


def apply_delay_pattern(tokens: torch.Tensor, pad_id: int = 0
                        ) -> torch.Tensor:
    """MusicGen delay pattern: codebook k is shifted right by k frames.

    tokens: (B, K, S) -> delayed (B, K, S). Positions that fall before the
    stream start are filled with ``pad_id``.
    """
    out = torch.full_like(tokens, pad_id)
    s = tokens.shape[2]
    for i in range(tokens.shape[1]):
        out[:, i, i:] = tokens[:, i, :max(s - i, 0)]
    return out


def undelay_pattern(tokens: torch.Tensor) -> torch.Tensor:
    """Inverse of `apply_delay_pattern` (best-effort; tail truncated)."""
    out = torch.zeros_like(tokens)
    s = tokens.shape[2]
    for i in range(tokens.shape[1]):
        out[:, i, :max(s - i, 0)] = tokens[:, i, i:]
    return out


def encodec_tokens(cfg: ModelConfig, generator: torch.Generator, batch: int,
                   seq_len: int) -> torch.Tensor:
    """Stub EnCodec tokenizer output: (B, K, S) int32 codebook ids,
    delayed."""
    toks = torch.randint(0, cfg.vocab_size,
                         (batch, cfg.num_codebooks, seq_len),
                         generator=generator, dtype=torch.int32,
                         device=generator.device)
    return apply_delay_pattern(toks)
