"""OLMoE-1B-7B — MoE decoder, 64 experts top-8, qk-norm.

[arXiv:2409.02060] 16L d_model=2048 16H (kv=16) d_ff=1024 (per expert)
vocab=50304, MoE 64e top-8, head_dim=128.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab_size=50_304,
    norm="rmsnorm",
    act="swiglu",
    rope="rope",
    rope_theta=1e4,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, capacity_factor=1.25),
    source="arXiv:2409.02060",
)


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
