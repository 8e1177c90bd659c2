"""InternVL2-2B: InternLM2 backbone with a stubbed InternViT front-end.

24L d_model=2048 16H (GQA kv=8) head_dim=128 d_ff=8192 vocab=92553,
SwiGLU, rope_theta 1e6 (same values as ``repro.configs.internvl2_2b``).
The vision tower is a stub: a request carries precomputed patch
embeddings (256 per image tile, ``Request.prefix_emb``) that precede its
token embeddings.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    activation="swiglu",
    rope_theta=1000000.0,
    frontend="vision_patches",
    n_prefix_embeddings=256,
)
