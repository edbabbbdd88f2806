"""Qwen3-32B — dense GQA decoder with per-head qk RMSNorm.

[hf:Qwen/Qwen3-8B family; assigned spec] 64L d_model=5120 64H (GQA kv=8)
d_ff=25600 vocab=151936, head_dim=128 (decoupled from d_model, per Qwen3).
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_head=128,
    d_ff=25600,
    vocab_size=151_936,
    norm="rmsnorm",
    act="swiglu",
    rope="rope",
    rope_theta=1e6,
    qk_norm=True,
    source="hf:Qwen/Qwen3-8B",
)


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
