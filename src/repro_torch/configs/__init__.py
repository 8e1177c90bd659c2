"""Architecture registry of the port: ``get_config(name)`` returns the full
published config, ``smoke_variant(cfg)`` the reduced same-family config the
CPU tests run (same reduction as ``repro.configs.smoke_variant``)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.config import ModelConfig, MoEConfig

from . import (
    gemma_7b,
    granite_moe_3b,
    grok1_314b,
    internvl2_2b,
    llama31_8b,
    llama32_3b,
    musicgen_large,
    nemotron4_340b,
    qwen3_8b,
    qwen3_32b,
    qwen15_4b,
    recurrentgemma_9b,
    rwkv6_3b,
)

#: every config of the JAX package's registry, in its order: the
#: ``("attn",)`` decoders (dense, MoE, the vision and audio front-ends'
#: backbones) and the recurrent families (recurrentgemma-9b, rwkv6-3b)
_MODULES = {
    "musicgen-large": musicgen_large,
    "qwen1.5-4b": qwen15_4b,
    "gemma-7b": gemma_7b,
    "llama3.2-3b": llama32_3b,
    "nemotron-4-340b": nemotron4_340b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "grok-1-314b": grok1_314b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "internvl2-2b": internvl2_2b,
    "rwkv6-3b": rwkv6_3b,
    "llama3.1-8b": llama31_8b,
    "qwen3-8b": qwen3_8b,
    "qwen3-32b": qwen3_32b,
}


def list_archs() -> Tuple[str, ...]:
    return tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    try:
        return _MODULES[name].CONFIG
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(_MODULES)}"
        ) from None


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Tiny widths, ``max(2, len(layer_pattern))`` layers, vocab 256,
    float32, a local window of 64; MHA and MQA kept; an MoE keeps top-K up
    to 2 of 4 experts at lossless capacity, a front-end up to 8 prefix
    embeddings."""
    n_heads = 4
    if cfg.n_kv_heads == cfg.n_heads:
        n_kv = n_heads
    elif cfg.n_kv_heads == 1:
        n_kv = 1
    else:
        n_kv = 2
    moe = cfg.moe
    if moe is not None:
        k = min(2, moe.experts_per_token)
        # lossless capacity (C == group tokens), as in JAX's smoke variant
        moe = MoEConfig(n_experts=4, experts_per_token=k,
                        router_aux_weight=moe.router_aux_weight,
                        capacity_factor=4.0 / k)
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
        moe=moe,
        local_window=64,
        n_prefix_embeddings=min(cfg.n_prefix_embeddings, 8),
        sparse=sparse,
        dtype="float32",
    )
