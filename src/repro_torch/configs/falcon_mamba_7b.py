"""Falcon-Mamba-7B — attention-free Mamba1 SSM decoder.

[arXiv:2410.05355] 64L d_model=4096 (attn-free) vocab=65024, ssm_state=16,
d_inner = 2*d_model = 8192, conv kernel 4.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65_024,
    norm="rmsnorm",
    act="swiglu",
    rope="none",
    ssm=SSMConfig(variant="mamba1", state_dim=16, conv_kernel=4, expand=2),
    tie_embeddings=True,
    source="arXiv:2410.05355",
)


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
