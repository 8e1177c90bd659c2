"""Llama-3.2-3B: small llama3 dense decoder.

28L d_model=3072 24H (GQA kv=8) head_dim=128 d_ff=8192 vocab=128256,
SwiGLU, tied embeddings (same values as ``repro.configs.llama32_3b``).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    activation="swiglu",
    rope_theta=500000.0,
    tie_embeddings=True,
)
