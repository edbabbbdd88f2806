"""MusicGen-Large — decoder-only LM over EnCodec tokens (audio frontend stub).

[arXiv:2306.05284] 48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048
per codebook, 4 codebooks with delay pattern, head_dim=64, LayerNorm+GELU.
Per assignment the EnCodec frontend is a STUB: input_specs() supplies
precomputed frame embeddings; the model predicts 4 codebooks per frame.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab_size=2048,
    norm="layernorm",
    act="gelu",
    rope="rope",
    rope_theta=1e4,
    num_codebooks=4,
    frontend="audio",
    source="arXiv:2306.05284",
)


def smoke_config() -> ModelConfig:
    return reduce_for_smoke(CONFIG)
