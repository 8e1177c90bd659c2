"""Common layers (counterpart of ``repro.models.layers``): RMSNorm, rotary
positions, SwiGLU MLP, attention projections, and the plain chunked causal
attention of dense prefill.  Weights keep the JAX package's
``[d_in, d_out]`` layout, so converted parameters copy as they are.
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


# -- chunked causal attention (plain online softmax; the dense-prefill oracle) --


def attn_chunk(S: int, target: int = 512) -> int:
    """Largest chunk ``<= target`` that divides S (JAX's prefill chunk)."""
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def chunked_causal_attention(
    q: torch.Tensor,               # [B, Hq, S, D]
    k: torch.Tensor,               # [B, Hkv, S, D]
    v: torch.Tensor,
    chunk: int = 512,
    causal_pairs: bool = True,
) -> torch.Tensor:
    """Causal attention by an online softmax over key chunks (f32), in
    JAX's order: with ``causal_pairs`` only the lower-triangular
    (query chunk, key chunk) pairs, else every key chunk against all
    queries.  ``chunk`` must divide S.  -> ``[B, Hq, S, D]`` in q's dtype.
    (JAX's ``window`` serves local attention, which is not ported.)"""
    if causal_pairs:
        return _causal_pair_attention(q, k, v, chunk)
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    n_chunks = S // chunk
    qf = q.reshape(B, Hkv, g, S, D).to(torch.float32)
    kc = k.reshape(B, Hkv, n_chunks, chunk, D).to(torch.float32)
    vc = v.reshape(B, Hkv, n_chunks, chunk, D).to(torch.float32)
    rows = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, g, S), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, g, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, g, S, D), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        cols = j * chunk + torch.arange(chunk, device=q.device)
        logits = torch.einsum("bhgsd,bhcd->bhgsc", qf, kc[:, :, j]) * scale
        mask = rows[:, None] >= cols[None, :]
        logits = torch.where(mask, logits, -1e30)
        m, l, acc = _online_step(m, l, acc, logits, vc[:, :, j])
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Hq, S, D).to(q.dtype)


def _online_step(m, l, acc, logits, v):
    """One online-softmax update of (max, sum, acc) by a block of logits
    ``[..., rows, keys]`` and its values ``[.., keys, D]``."""
    m_new = torch.maximum(m, logits.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bhgsc,bhcd->bhgsd", p, v)
    return m_new, l_new, acc_new


def _causal_pair_attention(q, k, v, chunk: int) -> torch.Tensor:
    """Causal attention over the lower-triangular (query chunk, key chunk)
    pairs only, in JAX's order (query chunk outer, key chunk inner), each
    pair updating its query chunk's flash statistics."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    n = S // chunk
    qc = q.reshape(B, Hkv, g, n, chunk, D).to(torch.float32)
    kc = k.reshape(B, Hkv, n, chunk, D).to(torch.float32)
    vc = v.reshape(B, Hkv, n, chunk, D).to(torch.float32)
    rows = torch.arange(chunk, device=q.device)
    diag = rows[:, None] >= rows[None, :]
    outs = []
    for qi in range(n):
        m = torch.full((B, Hkv, g, chunk), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, g, chunk, D), dtype=torch.float32,
                          device=q.device)
        for kj in range(qi + 1):
            logits = torch.einsum("bhgsd,bhcd->bhgsc", qc[:, :, :, qi],
                                  kc[:, :, kj]) * scale
            if kj == qi:
                logits = torch.where(diag, logits, -1e30)
            m, l, acc = _online_step(m, l, acc, logits, vc[:, :, kj])
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs, dim=3)                  # [B, Hkv, g, n, c, D]
    return out.reshape(B, Hq, S, D).to(q.dtype)
