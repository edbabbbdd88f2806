"""Zamba2-1.2B — hybrid: Mamba2 backbone + weight-shared attention blocks.

[arXiv:2411.15242] 38L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192
vocab=32000, ssm_state=64, head_dim=64. Zamba-style: ONE shared
attention+MLP block (weight-shared) applied after every 6 Mamba2 layers.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab_size=32_000,
    norm="rmsnorm",
    act="swiglu",
    rope="rope",
    rope_theta=1e4,
    ssm=SSMConfig(variant="mamba2", state_dim=64, conv_kernel=4, expand=2,
                  head_dim=64),
    attn_every=6,
    source="arXiv:2411.15242",
)


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
