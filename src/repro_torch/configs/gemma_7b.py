"""Gemma-7B: dense decoder, GeGLU, head_dim 256.

28L d_model=3072 16H (kv=16: MHA) head_dim=256 d_ff=24576 vocab=256000,
GeGLU (tanh GELU of the gate times up), rope_theta 1e4, tied embeddings
(same values as ``repro.configs.gemma_7b``).  n_heads * head_dim = 4096 is
not d_model: ``wq`` maps 3072 -> 4096 and ``wo`` 4096 -> 3072.  As in the
JAX package, the embedding is not scaled by sqrt(d_model) and the norms
multiply by their weight (no ``1 + w``).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    activation="geglu",
    rope_theta=10000.0,
    tie_embeddings=True,
)
