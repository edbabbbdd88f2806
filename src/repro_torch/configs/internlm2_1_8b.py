"""InternLM2-1.8B — dense GQA decoder.

[arXiv:2403.17297] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544,
head_dim=128.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=92_544,
    norm="rmsnorm",
    act="swiglu",
    rope="rope",
    rope_theta=1e6,
    source="arXiv:2403.17297",
)


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
