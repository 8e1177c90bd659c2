"""Grok-1-314B: large MoE, 8 experts top-2.

64L d_model=6144 48H (GQA kv=8) head_dim=128 d_ff=32768 per expert,
vocab=131072, GeGLU (same values as ``repro.configs.grok1_314b``).  About
628 GB of bf16 weights: no card holds it, so the port runs its smoke
variant only.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    activation="geglu",
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=8, experts_per_token=2),
)
