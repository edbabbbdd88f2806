"""Model architecture configs, copied from the JAX package.

Every architecture module exposes ``CONFIG`` (the exact published
configuration) and ``smoke_config()`` (a reduced same-family config for
CPU tests).  The port serves the dense family; the MoE / SSM fields stay
so that a config reads the same in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # d_ff of each expert is ModelConfig.d_ff (per-expert width).


@dataclass(frozen=True)
class SSMConfig:
    variant: str  # "mamba1" | "mamba2"
    state_dim: int
    conv_kernel: int = 4
    expand: int = 2            # d_inner = expand * d_model
    # mamba2 only:
    head_dim: int = 64
    chunk_size: int = 256
    # mamba2 execution: False = associative scan (elementwise, O(c) state
    # tensors); True = SSD block-matmul form (MXU-friendly (c,c) tiles,
    # ~10x smaller live tensors — see EXPERIMENTS.md §Perf cell D)
    ssd_matmul: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | ssm | hybrid | audio
    num_layers: int
    d_model: int
    num_heads: int              # 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 -> d_model // num_heads
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"         # swiglu | gelu
    rope: str = "rope"          # rope | mrope | none
    rope_theta: float = 1e4
    qk_norm: bool = False
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Zamba-style): a single weight-shared attention+MLP block applied
    # after every `attn_every` SSM layers.
    attn_every: int = 0
    # audio (MusicGen): number of parallel codebooks predicted per frame.
    num_codebooks: int = 0
    # vlm: fraction of the sequence that may be image patches (frontend stub).
    frontend: Optional[str] = None   # vision | audio | None
    max_seq_len: int = 524_288
    dtype: str = "bfloat16"
    # citation provenance for the record
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.num_heads, 1)


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: small widths, few experts, tiny vocab."""
    updates = dict(
        num_layers=min(cfg.num_layers, 2 if cfg.family != "hybrid" else 4),
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=(2 if cfg.num_kv_heads and cfg.num_kv_heads <
                      cfg.num_heads else (4 if cfg.num_heads else 0)),
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        d_head=16 if cfg.num_heads else 0,
        max_seq_len=512,
        dtype="float32",
    )
    if cfg.moe:
        updates["moe"] = MoEConfig(num_experts=4,
                                   top_k=min(cfg.moe.top_k, 2),
                                   capacity_factor=2.0)
    if cfg.ssm:
        updates["ssm"] = SSMConfig(variant=cfg.ssm.variant, state_dim=8,
                                   conv_kernel=4, expand=2, head_dim=16,
                                   chunk_size=32)
    if cfg.attn_every:
        updates["attn_every"] = 2
    return dataclasses.replace(cfg, **updates)

