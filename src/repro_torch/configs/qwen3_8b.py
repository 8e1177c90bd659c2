"""Qwen3-8B: a paper evaluation model.

36L d_model=4096 32H (GQA kv=8) head_dim=128 d_ff=12288 vocab=151936,
SwiGLU, rope_theta 1e6, untied embeddings (same values as
``repro.configs.qwen3_8b``, which has no per-head q/k RMSNorm).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    activation="swiglu",
    rope_theta=1000000.0,
)
