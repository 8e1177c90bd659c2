"""MusicGen-Large: a decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (MHA: kv=32) head_dim=64 d_ff=8192 vocab=2048,
GELU MLP, untied head (same values as ``repro.configs.musicgen_large``).
Sinusoidal absolute positions are added to the embeddings on top of RoPE
(``Transformer`` tests the name, as JAX does).  The EnCodec front-end is
a stub: a request may carry precomputed frame embeddings
(``Request.prefix_emb``) that precede its tokens.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    activation="gelu",
    rope_theta=10000.0,
    frontend="audio_frames",
    n_prefix_embeddings=0,
)
