"""RecurrentGemma-9B: the Griffin hybrid of RG-LRU recurrent blocks and
local attention, two recurrent blocks to one local-attention block.

38L d_model=4096 16H (MQA: kv=1) head_dim=256 d_ff=12288 vocab=256000,
GeGLU, tied embeddings, window 2048 (same values as
``repro.configs.recurrentgemma_9b``).  The layers cycle (rglru, rglru,
local_attn): 12 cycles, then rglru, rglru.  Local attention keeps a fixed
2048-token window, so nothing grows for AB-Sparse's block selection to
prune: the sparse path is off.
"""
from repro_torch.config import ModelConfig, SparseConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    activation="geglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    layer_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    sparse=SparseConfig(enabled=False),
)
