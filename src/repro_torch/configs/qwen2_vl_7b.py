"""Qwen2-VL-7B — VLM: dense GQA backbone + M-RoPE; vision frontend stubbed.

[arXiv:2409.12191] 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
head_dim=128. Per assignment the modality frontend is a STUB: input_specs()
supplies precomputed patch embeddings scattered into the token sequence.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_head=128,
    d_ff=18_944,
    vocab_size=152_064,
    norm="rmsnorm",
    act="swiglu",
    rope="mrope",
    rope_theta=1e6,
    frontend="vision",
    source="arXiv:2409.12191",
)


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
