"""StarCoder2-15B — dense GQA decoder, LayerNorm + GELU, RoPE.

[arXiv:2402.19173] 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152,
head_dim=128.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_head=128,
    d_ff=24_576,
    vocab_size=49_152,
    norm="layernorm",
    act="gelu",
    rope="rope",
    rope_theta=1e5,
    source="arXiv:2402.19173",
)


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
