"""Carry JAX parameters into the port.

``params_from_jax`` takes the parameter tree of ``repro``'s
``Transformer.init`` as numpy arrays and returns a port
:class:`Transformer` holding the same weights.  The tree holds ``embed``,
``final_norm``, optional ``lm_head``, and the layers: ``cycles.pos{i}``
stacked over the pattern's cycles (layer ``c * len(pattern) + i``), then
``rest[j]`` (the remainder layers, in order).  Each layer holds
``norm1``, ``norm2``, its kind's mixing (``attn.{wq,wk,wv,wo}`` with the
biases under ``qkv_bias``; rglru's ``rec.*``; rwkv's ``tmix.*``) and the
FFN (``ffn.{up,gate,down}``, no ``gate`` for a non-gated activation; an
MoE's ``ffn.router.w`` in f32 and its ``ffn.{up,gate,down}`` as raw ``[E,
...]`` arrays).  bfloat16 arrays travel bit-exactly through a uint16 view.
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


_COMMON_KEYS = {
    "norm1": ("norm1", "scale"), "norm2": ("norm2", "scale"),
    "up": ("ffn", "up", "w"), "gate": ("ffn", "gate", "w"),
    "down": ("ffn", "down", "w"),
}
_ATTN_KEYS = {
    "wq": ("attn", "wq", "w"), "wk": ("attn", "wk", "w"),
    "wv": ("attn", "wv", "w"), "wo": ("attn", "wo", "w"),
    "bq": ("attn", "wq", "b"), "bk": ("attn", "wk", "b"),
    "bv": ("attn", "wv", "b"),
}
#: an attention layer's leaves
_LAYER_KEYS = {**_COMMON_KEYS, **_ATTN_KEYS}
#: each kind's mixing leaves
_KIND_KEYS = {
    "attn": _ATTN_KEYS,
    "local_attn": _ATTN_KEYS,
    "rglru": {
        **{n: ("rec", n, "w") for n in ("in_gelu", "in_rec", "w_a", "w_x", "out")},
        **{n: ("rec", n) for n in ("conv_w", "conv_b", "lam")},
    },
    "rwkv": {
        **{n: ("tmix", n, "w") for n in ("wr", "wk", "wv", "wg", "ww", "wo")},
        **{n: ("tmix", n) for n in ("mu", "w_bias", "u")},
        "ln_x": ("tmix", "ln_x", "scale"),
    },
}
#: an MoE layer's FFN leaves: the experts' arrays have no ``"w"`` level
_MOE_KEYS = {"router": ("ffn", "router", "w"), "up": ("ffn", "up"),
             "gate": ("ffn", "gate"), "down": ("ffn", "down")}


def layer_keys(cfg: ModelConfig, kind: str = "attn") -> dict:
    """Port parameter name -> its path within a JAX layer of ``kind``."""
    keys = {**_COMMON_KEYS, **_KIND_KEYS[kind]}
    return keys if cfg.moe is None else {**keys, **_MOE_KEYS}


def jax_layer(tree: Mapping, cfg: ModelConfig, layer: int):
    """(layer ``layer``'s parameter tree, its index along the stacked
    cycle axis, or None for a remainder layer)."""
    n = len(cfg.layer_pattern)
    n_cycles = cfg.n_layers // n
    if layer < n_cycles * n:
        return tree["cycles"][f"pos{layer % n}"], layer // n
    return tree["rest"][layer - n_cycles * n], None


def params_from_jax(tree: Mapping, cfg: ModelConfig, device="cuda") -> Transformer:
    """JAX ``Transformer.init`` parameters (numpy leaves) -> port model."""
    model = Transformer(cfg, device=device)
    dev = model.device
    with torch.no_grad():
        model.embed.copy_(to_torch(tree["embed"], dev))
        model.final_norm.copy_(to_torch(tree["final_norm"]["scale"], dev))
        if model.lm_head is not None:
            model.lm_head.copy_(to_torch(tree["lm_head"], dev))
        for l, layer in enumerate(model.layers):
            node0, c = jax_layer(tree, cfg, l)
            keys = layer_keys(cfg, layer.kind)
            for name, p in layer.named_parameters():
                node = node0
                for key in keys[name]:
                    node = node[key]
                a = np.asarray(node)
                p.copy_(to_torch(a if c is None else a[c], dev))
    return model
