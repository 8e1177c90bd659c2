"""Carry JAX parameters into the port.

``params_from_jax`` takes the parameter tree of ``repro``'s
``Transformer.init`` as numpy arrays (stacked ``cycles.pos0.{norm1,norm2,
attn.{wq,wk,wv,wo},ffn.{up,gate,down}}``, the attention biases with
``qkv_bias``, no ``gate`` for a non-gated activation, ``embed``,
``final_norm``, optional ``lm_head``; an MoE's ``ffn.router.w`` in f32 and
its ``ffn.{up,gate,down}`` as raw ``[E, ...]`` arrays) and returns a port
:class:`Transformer` holding the same weights.  bfloat16 arrays travel bit-exactly through a uint16 view.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import Transformer


def to_torch(a: Any, device=None) -> torch.Tensor:
    """numpy (or array-like) -> tensor; bfloat16 arrays bit-exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy; a bfloat16 tensor comes back as its raw uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


_LAYER_KEYS = {
    "norm1": ("norm1", "scale"), "norm2": ("norm2", "scale"),
    "wq": ("attn", "wq", "w"), "wk": ("attn", "wk", "w"),
    "wv": ("attn", "wv", "w"), "wo": ("attn", "wo", "w"),
    "bq": ("attn", "wq", "b"), "bk": ("attn", "wk", "b"),
    "bv": ("attn", "wv", "b"),
    "up": ("ffn", "up", "w"), "gate": ("ffn", "gate", "w"),
    "down": ("ffn", "down", "w"),
}
#: an MoE layer's FFN leaves: the experts' arrays have no ``"w"`` level
_MOE_KEYS = {"router": ("ffn", "router", "w"), "up": ("ffn", "up"),
             "gate": ("ffn", "gate"), "down": ("ffn", "down")}


def layer_keys(cfg: ModelConfig) -> dict:
    """Port parameter name -> its path under ``cycles.pos0`` for ``cfg``."""
    return _LAYER_KEYS if cfg.moe is None else {**_LAYER_KEYS, **_MOE_KEYS}


def params_from_jax(tree: Mapping, cfg: ModelConfig, device="cuda") -> Transformer:
    """JAX ``Transformer.init`` parameters (numpy leaves) -> port model."""
    model = Transformer(cfg, device=device)
    dev = model.device
    with torch.no_grad():
        model.embed.copy_(to_torch(tree["embed"], dev))
        model.final_norm.copy_(to_torch(tree["final_norm"]["scale"], dev))
        if model.lm_head is not None:
            model.lm_head.copy_(to_torch(tree["lm_head"], dev))
        cyc, keys = tree["cycles"]["pos0"], layer_keys(cfg)
        for l, layer in enumerate(model.layers):
            for name, p in layer.named_parameters():
                node = cyc
                for key in keys[name]:
                    node = node[key]
                p.copy_(to_torch(np.asarray(node)[l], dev))
    return model
