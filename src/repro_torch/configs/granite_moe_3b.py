"""Granite-MoE-3B-A800M: fine-grained MoE, 40 experts top-8.

32L d_model=1536 24H (GQA kv=8) head_dim=64 d_ff=512 per expert,
vocab=49155, SwiGLU, tied embeddings, capacity factor 1.25 (same values
as ``repro.configs.granite_moe_3b``).
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    activation="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, experts_per_token=8),
)
