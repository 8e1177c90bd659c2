"""Architecture registry of the port: ``get_config(name)`` returns the full
published config, ``smoke_variant(cfg)`` the reduced same-family config the
CPU tests run (same reduction as ``repro.configs.smoke_variant``)."""
from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig

from . import llama32_3b, qwen3_8b

_MODULES = {"llama3.2-3b": llama32_3b, "qwen3-8b": qwen3_8b}


def get_config(name: str) -> ModelConfig:
    try:
        return _MODULES[name].CONFIG
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(_MODULES)}"
        ) from None


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Tiny widths, two layers, vocab 256, float32."""
    n_heads = 4
    if cfg.n_kv_heads == cfg.n_heads:
        n_kv = n_heads
    elif cfg.n_kv_heads == 1:
        n_kv = 1
    else:
        n_kv = 2
    sparse = dataclasses.replace(
        cfg.sparse, token_budget=64, block_sizes=None, sink_pages=1,
        local_pages=1,
    )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(2, len(cfg.layer_pattern)),
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128,
        vocab_size=256,
        sparse=sparse,
        dtype="float32",
    )
