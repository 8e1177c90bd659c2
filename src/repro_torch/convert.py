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
``train_state_from_jax`` carries a training state (parameters and
optimizer trees) the same way.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import Transformer
from repro_torch.training.optimizer import OptState


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


def jax_leaf(tree: Mapping, cfg: ModelConfig, name: str):
    """The array (or None) of JAX tree ``tree`` (``Transformer.init``'s
    structure: the parameters, or an optimizer tree of the same shape) at
    the port's parameter ``name`` (``Transformer.named_parameters``)."""
    if name == "final_norm":
        return tree["final_norm"]["scale"]
    if not name.startswith("layers."):
        return tree[name]
    _, l, pname = name.split(".")
    node, c = jax_layer(tree, cfg, int(l))
    for key in layer_keys(cfg, cfg.layer_kinds[int(l)])[pname]:
        node = node[key]
    return node if node is None or c is None else np.asarray(node)[c]


def params_from_jax(tree: Mapping, cfg: ModelConfig, device="cuda") -> Transformer:
    """JAX ``Transformer.init`` parameters (numpy leaves) -> port model."""
    model = Transformer(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(to_torch(jax_leaf(tree, cfg, name), model.device))
    return model


def train_state_from_jax(state: Mapping, cfg: ModelConfig, device="cuda"):
    """JAX's training state ``{"params", "opt": OptState}`` (numpy leaves)
    -> (port model, port :class:`~repro_torch.training.optimizer.OptState`):
    ``m``, ``v``, ``master`` and ``error`` by the parameters' key map (None
    where JAX's leaf is None), ``step`` carried over."""
    model = params_from_jax(state["params"], cfg, device)
    opt = state["opt"]

    def tree(t):
        out = {}
        for name, _ in model.named_parameters():
            a = jax_leaf(t, cfg, name)
            out[name] = None if a is None else to_torch(a, model.device)
        return out

    return model, OptState(int(np.asarray(opt.step)), tree(opt.m), tree(opt.v),
                           tree(opt.master), tree(opt.error))
