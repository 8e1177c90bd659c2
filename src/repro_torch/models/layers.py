"""Common layers (counterpart of ``repro.models.layers``): RMSNorm, rotary
positions, SwiGLU MLP, attention projections.  Weights keep the JAX
package's ``[d_in, d_out]`` layout, so converted parameters copy as they are.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[..., S, n, D]`` rotated by position ``[..., S]``: the half-split
    form (channel i pairs with i + D/2), computed in f32."""
    D = x.shape[-1]
    half = D // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[..., None].to(torch.float32) * freqs   # [..., S, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y.to(x.dtype)


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm attention + SwiGLU block's weights."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.norm1 = _weight((d,), dtype, device)
        self.norm2 = _weight((d,), dtype, device)
        self.wq = _weight((d, cfg.n_heads * hd), dtype, device)
        self.wk = _weight((d, cfg.n_kv_heads * hd), dtype, device)
        self.wv = _weight((d, cfg.n_kv_heads * hd), dtype, device)
        self.wo = _weight((cfg.n_heads * hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _weight((cfg.n_heads * hd,), dtype, device)
            self.bk = _weight((cfg.n_kv_heads * hd,), dtype, device)
            self.bv = _weight((cfg.n_kv_heads * hd,), dtype, device)
        else:
            self.bq = self.bk = self.bv = None
        self.up = _weight((d, cfg.d_ff), dtype, device)
        self.gate = _weight((d, cfg.d_ff), dtype, device)
        self.down = _weight((cfg.d_ff, d), dtype, device)


def mlp(p: DecoderLayer, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation != "swiglu":
        raise NotImplementedError(f"activation {activation!r} is not ported")
    up = dense(x, p.up)
    h = F.silu(dense(x, p.gate)) * up
    return dense(h, p.down)


def qkv_project(
    p: DecoderLayer, x: torch.Tensor, cfg, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> q ``[B, S, Hq, hd]``, k/v ``[B, S, Hkv, hd]``
    (rotary positions applied to q and k)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(x, p.wq, p.bq).reshape(B, S, cfg.n_heads, hd)
    k = dense(x, p.wk, p.bk).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(x, p.wv, p.bv).reshape(B, S, cfg.n_kv_heads, hd)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def out_project(p: DecoderLayer, attn_out: torch.Tensor) -> torch.Tensor:
    """attn_out ``[B, S, Hq, hd]`` -> ``[B, S, d]``."""
    B, S = attn_out.shape[:2]
    return dense(attn_out.reshape(B, S, -1), p.wo)
