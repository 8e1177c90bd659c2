"""Nemotron-4-340B: very large dense decoder, squared-ReLU MLP.

96L d_model=18432 96H (GQA kv=8) head_dim=192 d_ff=73728 vocab=256000,
ReLU^2 (non-gated: no ``gate`` projection), rope_theta 1e4, untied
embeddings (same values as ``repro.configs.nemotron4_340b``).

Its smoke variant runs anywhere.  At full width (340B parameters) it fits
no single card, and its head_dim of 192 is not one the attention kernels
take (64, 128 or 256): a CUDA call raises at the kernels' head_dim check.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="relu2",
    rope_theta=10000.0,
)
