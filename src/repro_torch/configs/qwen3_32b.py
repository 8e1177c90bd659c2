"""Qwen3-32B: a paper evaluation model.

64L d_model=5120 64H (GQA kv=8, group 8) head_dim=128 d_ff=25600
vocab=151936, SwiGLU, rope_theta 1e6, untied embeddings (same values as
``repro.configs.qwen3_32b``, which has no per-head q/k RMSNorm).  At the
default ``prefill_block_q`` of 64 a sparse-prefill query block holds
8 x 64 = 512 query rows per kv head.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    activation="swiglu",
    rope_theta=1000000.0,
)
