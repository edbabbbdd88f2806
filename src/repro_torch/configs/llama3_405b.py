"""Llama-3 405B — dense GQA decoder, 128k vocab.

[arXiv:2407.21783] 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256, head_dim=128.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16_384,
    num_heads=128,
    num_kv_heads=8,
    d_head=128,
    d_ff=53_248,
    vocab_size=128_256,
    norm="rmsnorm",
    act="swiglu",
    rope="rope",
    rope_theta=5e5,
    source="arXiv:2407.21783",
)


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
