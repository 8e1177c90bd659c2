"""Llama-3.1-8B: the paper's primary evaluation model.

32L d_model=4096 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=128256,
SwiGLU, rope_theta 5e5, untied embeddings (same values as
``repro.configs.llama31_8b``).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    activation="swiglu",
    rope_theta=500000.0,
)
