"""RWKV-6 (Finch) 3B: attention-free time mixing with data-dependent decay.

32L d_model=2560 40 time-mix heads of 64, d_ff=8960 (squared-ReLU channel
mix), vocab=65536 (same values as ``repro.configs.rwkv6_3b``).  No KV
cache and no block selection: the sparse path is off, and the decode
state is O(1) in the context length.
"""
from repro_torch.config import ModelConfig, SparseConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    activation="relu2",
    layer_pattern=("rwkv",),
    rwkv_head_dim=64,
    sparse=SparseConfig(enabled=False),
)
