"""Qwen1.5-4B: dense decoder with QKV bias.

40L d_model=2560 20H (kv=20: MHA, GQA group 1) head_dim=128 d_ff=6912
vocab=151936, SwiGLU, bias on the q / k / v projections, rope_theta 1e6,
untied embeddings (same values as ``repro.configs.qwen15_4b``).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1000000.0,
)
