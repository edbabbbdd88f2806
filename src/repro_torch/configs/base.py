"""Model architecture configs, copied from the JAX package.

Every architecture module exposes ``CONFIG`` (the exact published
configuration) and ``smoke_config()`` (a reduced same-family config for
CPU tests).  The port serves every family of the JAX package: the
transformer ones (dense, MoE, VLM, audio), the attention-free SSM
(Mamba1) and the hybrid (a Mamba2 backbone with one weight-shared
attention block).  ``param_count`` and ``active_param_count`` are the
JAX package's analytic counts, codebooks included and the hybrid's
shared block counted once; ``ShapeConfig``, ``SHAPES`` and
``shapes_for`` are its four global input shapes
(`repro_torch.models.io` builds their inputs).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


#: the model families the port serves
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")

#: the families whose layers are Mamba blocks (their caches hold SSM
#: state; the hybrid's also one shared attention block's KV)
SSM_FAMILIES = ("ssm", "hybrid")


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

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs accounting),
        the JAX package's count."""
        if self.family not in FAMILIES:
            raise ValueError(f"{self.name}: the port counts the parameters "
                             f"of the {FAMILIES} families only")
        d, v, L = self.d_model, self.vocab_size, self.num_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per_layer = _mamba_params(self)
        elif self.family == "hybrid":
            per_layer = _mamba_params(self)
            # one shared attention+MLP block (counted once)
            emb += _attn_params(self) + _ffn_params(self, self.d_ff)
        else:
            per_layer = _attn_params(self) + _moe_or_ffn_params(self)
        if self.num_codebooks:
            emb += (self.num_codebooks - 1) * v * d  # extra heads + embeds
        return emb + L * per_layer

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count()
        L = self.num_layers
        expert = _ffn_params(self, self.d_ff)
        inactive = L * (self.moe.num_experts - self.moe.top_k) * expert
        return self.param_count() - inactive


def _attn_params(cfg: ModelConfig) -> int:
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return d * h * dh + 2 * d * kv * dh + h * dh * d


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 3 if cfg.act == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def _moe_or_ffn_params(cfg: ModelConfig) -> int:
    if cfg.moe:
        return cfg.moe.num_experts * _ffn_params(cfg, cfg.d_ff) + \
            cfg.d_model * cfg.moe.num_experts
    return _ffn_params(cfg, cfg.d_ff)


def _mamba_params(cfg: ModelConfig) -> int:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm.state_dim
    # in_proj (x,z), conv, dt/B/C proj, out_proj (dominant terms)
    return 2 * d * di + di * cfg.ssm.conv_kernel + \
        di * (2 * n + di // 16) + di * d


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



# ---------------------------------------------------------------------------
# Input shapes: the JAX package's four global shapes of every LM arch.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """long_500k needs sub-quadratic sequence handling: SSM/hybrid only."""
    if cfg.family in ("ssm", "hybrid"):
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)


SMOKE_SHAPE = ShapeConfig("smoke", "train", 32, 2)
