"""Phi-3.5-MoE (42B total / 6.6B active) — MoE decoder, 16 experts top-2.

[hf:microsoft/Phi-3.5-MoE-instruct] 32L d_model=4096 32H (GQA kv=8)
d_ff=6400 (per expert) vocab=32064, MoE 16e top-2, head_dim=128.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_head=128,
    d_ff=6400,
    vocab_size=32_064,
    norm="layernorm",
    act="swiglu",
    rope="rope",
    rope_theta=1e4,
    moe=MoEConfig(num_experts=16, top_k=2, capacity_factor=1.25),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
