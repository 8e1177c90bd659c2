"""Common layers (counterpart of ``repro.models.layers``): RMSNorm, rotary
and sinusoidal positions, the MLP (SwiGLU, GeGLU, ReLU^2, GELU) or the MoE FFN
(``ffn``), attention projections, the plain chunked causal attention of
dense prefill (global, or local within a window) and the masked dense
decode attention of a local-attention ring buffer.  Weights keep the JAX
package's ``[d_in, d_out]`` layout, so converted parameters copy as they
are.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.moe import moe_ffn


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


def sinusoidal_embedding(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute positions ``[...]`` -> ``[..., d]`` f32 ``[sin, cos]`` over
    ``d / 2`` frequencies (JAX's ``sinusoidal_embedding``), computed on the
    positions' device."""
    half = d // 2
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=positions.device) / half
    )
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def dense(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y.to(x.dtype)


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


#: activations whose MLP multiplies ``up`` by an activated ``gate``
GATED = {"swiglu", "geglu"}


#: the mixing weights of each layer kind, JAX's names (``b*``: the
#: attention biases, with ``qkv_bias``)
KIND_PARAMS = {
    "attn": ("wq", "wk", "wv", "wo", "bq", "bk", "bv"),
    "local_attn": ("wq", "wk", "wv", "wo", "bq", "bk", "bv"),
    "rglru": ("in_gelu", "in_rec", "conv_w", "conv_b", "w_a", "w_x", "lam", "out"),
    "rwkv": ("mu", "wr", "wk", "wv", "wg", "ww", "w_bias", "u", "wo", "ln_x"),
}


class DecoderLayer(nn.Module):
    """One pre-norm block's weights: the mixing of its ``kind`` (see
    :data:`KIND_PARAMS`), then the FFN (``gate`` only for a gated
    activation).  "attn" / "local_attn": the attention projections;
    "rglru": Griffin's recurrent block (:mod:`.rglru`, ``lam`` f32);
    "rwkv": RWKV-6 time mixing (:mod:`.rwkv6`, ``mu``, ``w_bias`` and ``u``
    f32).  With ``cfg.moe`` the FFN is the experts' (``up`` / ``gate``
    ``[E, d, ff]``, ``down`` ``[E, ff, d]``) and their router (``[d, E]``,
    f32 in any model dtype, as JAX keeps it)."""

    def __init__(self, cfg, dtype, device, kind: str = "attn"):
        super().__init__()
        if kind not in KIND_PARAMS:
            raise ValueError(f"unknown layer kind {kind!r}")
        self.kind = kind
        d, hd = cfg.d_model, cfg.resolved_head_dim
        f32 = torch.float32
        self.norm1 = _weight((d,), dtype, device)
        self.norm2 = _weight((d,), dtype, device)
        if kind in ("attn", "local_attn"):
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
        elif kind == "rglru":
            lru = d                                 # rglru.lru_width
            for name in ("in_gelu", "in_rec"):
                setattr(self, name, _weight((d, lru), dtype, device))
            self.conv_w = _weight((4, lru), dtype, device)     # rglru.CONV_K taps
            self.conv_b = _weight((lru,), dtype, device)
            self.w_a = _weight((lru, lru), dtype, device)
            self.w_x = _weight((lru, lru), dtype, device)
            self.lam = _weight((lru,), f32, device)
            self.out = _weight((lru, d), dtype, device)
        else:
            self.mu = _weight((5, d), f32, device)
            for name in ("wr", "wk", "wv", "wg", "ww", "wo"):
                setattr(self, name, _weight((d, d), dtype, device))
            self.w_bias = _weight((d,), f32, device)
            self.u = _weight((d,), f32, device)
            self.ln_x = _weight((d,), dtype, device)
        ff = cfg.d_ff
        E = () if cfg.moe is None else (cfg.moe.n_experts,)
        self.router = (None if cfg.moe is None else
                       _weight((d, cfg.moe.n_experts), torch.float32, device))
        self.up = _weight(E + (d, ff), dtype, device)
        self.gate = (_weight(E + (d, ff), dtype, device)
                     if cfg.activation in GATED else None)
        self.down = _weight(E + (ff, d), dtype, device)


def ffn(p: DecoderLayer, x: torch.Tensor, cfg, group_size: int = 512,
        n_tokens=None) -> torch.Tensor:
    """The block's FFN: :func:`mlp`, or with ``cfg.moe`` the MoE FFN over
    groups of ``group_size`` tokens (``n_tokens``: see
    :func:`repro_torch.models.moe.moe_ffn`)."""
    if cfg.moe is None:
        return mlp(p, x, cfg.activation)
    return moe_ffn(p, x, cfg, group_size=group_size, n_tokens=n_tokens)


def mlp(p: DecoderLayer, x: torch.Tensor, activation: str) -> torch.Tensor:
    """JAX's ``mlp``: GELU is its tanh form (``approximate=True``)."""
    up = dense(x, p.up)
    if activation == "swiglu":
        h = F.silu(dense(x, p.gate)) * up
    elif activation == "geglu":
        h = F.gelu(dense(x, p.gate), approximate="tanh") * up
    elif activation == "relu2":
        h = torch.square(F.relu(up))
    elif activation == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(activation)
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
    window=None,
) -> torch.Tensor:
    """Causal attention by an online softmax over key chunks (f32), in
    JAX's order: with ``causal_pairs`` only the lower-triangular
    (query chunk, key chunk) pairs, else every key chunk against all
    queries.  ``chunk`` must divide S, except with ``window`` (local
    attention): query row ``i`` then attends the keys ``j`` with ``i -
    window < j <= i`` (JAX's mask ``rows < cols + window``), each query
    chunk over the key chunks that hold such keys only (JAX scans every
    chunk; one wholly outside the window adds nothing there), and a last
    chunk past S is padded.  -> ``[B, Hq, S, D]`` in q's dtype."""
    if window is not None:
        return _windowed_attention(q, k, v, chunk, window)
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


def _windowed_attention(q, k, v, chunk: int, window: int) -> torch.Tensor:
    """Local causal attention: each query chunk against the key chunks from
    the one holding its first row's oldest key to its own, masked by
    ``rows >= cols`` and ``rows < cols + window``, in key-chunk order (rows
    past S padded: a real row attends no padded key)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    pad = -S % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    n = (S + pad) // chunk
    qc = q.reshape(B, Hkv, g, n, chunk, D).to(torch.float32)
    kc = k.reshape(B, Hkv, n, chunk, D).to(torch.float32)
    vc = v.reshape(B, Hkv, n, chunk, D).to(torch.float32)
    rel = torch.arange(chunk, device=q.device)
    outs = []
    for qi in range(n):
        rows = qi * chunk + rel
        m = torch.full((B, Hkv, g, chunk), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, g, chunk, D), dtype=torch.float32,
                          device=q.device)
        for kj in range(max(0, (qi * chunk - window + 1) // chunk), qi + 1):
            cols = kj * chunk + rel
            mask = (rows[:, None] >= cols[None]) & (rows[:, None] < cols[None] + window)
            logits = torch.einsum("bhgsd,bhcd->bhgsc", qc[:, :, :, qi],
                                  kc[:, :, kj]) * scale
            logits = torch.where(mask, logits, -1e30)
            m, l, acc = _online_step(m, l, acc, logits, vc[:, :, kj])
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs, dim=3)                  # [B, Hkv, g, n, c, D]
    return out.reshape(B, Hq, n * chunk, D)[:, :, :S].to(q.dtype)


def ring_valid(seq_len: torch.Tensor, W: int) -> torch.Tensor:
    """Which slots of a ``W``-row ring buffer hold a live key once the token
    at position ``seq_len`` (``[B]``) is written -> ``[B, W]`` bool: slot
    ``s`` holds the largest position ``p <= seq_len`` with ``p % W == s``,
    live when ``seq_len - W < p`` and ``p >= 0`` (JAX's
    ``_local_attn_decode``), all from device tensors."""
    sl = seq_len.long()[:, None]
    pos = sl - torch.remainder(sl - torch.arange(W, device=seq_len.device), W)
    return (pos >= 0) & (pos > sl - W)


def masked_dense_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """One query per head ``q [B, Hq, D]`` over ``k``/``v`` ``[B, Hkv, W,
    D]`` where ``valid`` (``[B, W]``) holds, in f32 (JAX's
    ``_masked_dense_decode``; groups of any size) -> ``[B, Hq, D]``."""
    B, Hkv, W, D = k.shape
    g = q.shape[1] // Hkv
    qf = q.reshape(B, Hkv, g, D).to(torch.float32)
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, k.to(torch.float32))
    logits = logits / math.sqrt(D)
    logits = torch.where(valid[:, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, v.to(torch.float32))
    return out.reshape(B, q.shape[1], D).to(q.dtype)
