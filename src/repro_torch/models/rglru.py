"""RG-LRU recurrent block (RecurrentGemma / Griffin), counterpart of
``repro.models.rglru``.

Real-Gated Linear Recurrent Unit, per channel:

  r_t = sigmoid(W_a u_t), i_t = sigmoid(W_x u_t)
  a_t = exp(-C softplus(lam) r_t)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)

where ``u`` is the width-``lru`` input branch after a causal temporal
convolution of ``CONV_K`` taps; the block's output is ``out(gelu(in_gelu
x) * h)``.  Prefill runs the recurrence as a log-depth (Hillis-Steele)
scan over time in f32, JAX's ``associative_scan`` in spirit, and returns
the final state with the output (JAX runs the projections a second time
for the state; the values are the same).  Decode is an O(1) update of the
state ``(h [B, lru] f32, conv tail [B, CONV_K - 1, lru])``, the tail being
the last ``CONV_K - 1`` input rows before the convolution; it sums the
convolution's taps as prefill does (JAX's decode takes an einsum), so the
two round alike in bf16.

The weights are a :class:`~repro_torch.models.layers.DecoderLayer`'s
(``in_gelu``, ``in_rec``, ``conv_w``, ``conv_b``, ``w_a``, ``w_x``, ``lam``
in f32, ``out``), in JAX's ``[d_in, d_out]`` layout.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense

C_FACTOR = 8.0
CONV_K = 4


def lru_width(cfg) -> int:
    return cfg.d_model


def init_state(cfg, batch: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero state: ``h [B, lru]`` f32 and the conv tail ``[B, CONV_K - 1,
    lru]`` in the model dtype."""
    lru = lru_width(cfg)
    return (torch.zeros((batch, lru), dtype=torch.float32, device=device),
            torch.zeros((batch, CONV_K - 1, lru), dtype=dtype, device=device))


def _decay(p, r: torch.Tensor) -> torch.Tensor:
    return torch.exp(-C_FACTOR * F.softplus(p.lam) * r)


def _conv_full(p, u: torch.Tensor) -> torch.Tensor:
    """Causal temporal convolution of ``u [B, S, lru]`` (zeros before the
    first row), tap by tap in JAX's order."""
    return _taps(p, F.pad(u, (0, 0, CONV_K - 1, 0)), u.shape[1])


def _taps(p, pads: torch.Tensor, S: int) -> torch.Tensor:
    """Rows ``t`` of ``sum_i pads[:, t + i] * conv_w[i] + conv_b``, summed
    tap by tap in the model dtype (prefill and decode round alike)."""
    out = pads[:, 0:S] * p.conv_w[0]
    for i in range(1, CONV_K):
        out = out + pads[:, i:i + S] * p.conv_w[i]
    return out + p.conv_b


def _gates(p, uc: torch.Tensor):
    """(a, b) of the recurrence ``h_t = a_t h_{t-1} + b_t`` in f32."""
    r = torch.sigmoid(dense(uc, p.w_a).float())
    i = torch.sigmoid(dense(uc, p.w_x).float())
    a = _decay(p, r)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) * (i * uc.float())
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All ``h_t = a_t h_{t-1} + b_t`` (``h_{-1} = 0``) over axis 1 of
    ``[B, S, ...]`` by a Hillis-Steele scan: ceil(log2 S) steps, each
    combining every element with the one ``d`` rows before it."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_block(p, x: torch.Tensor, cfg):
    """Full-sequence pass: ``x [B, S, d]`` -> (``[B, S, d]``, final state
    ``(h [B, lru] f32, conv tail [B, CONV_K - 1, lru])``)."""
    gate = F.gelu(dense(x, p.in_gelu), approximate="tanh")
    u = dense(x, p.in_rec)
    uc = _conv_full(p, u)
    a, b = _gates(p, uc)
    h = linear_scan(a, b)
    y = gate.float() * h
    tail = F.pad(u, (0, 0, max(0, CONV_K - 1 - u.shape[1]), 0))[:, -(CONV_K - 1):]
    return dense(y.to(x.dtype), p.out), (h[:, -1], tail)


def rglru_decode(p, x: torch.Tensor, state, cfg):
    """One token: ``x [B, 1, d]``, state ``(h, conv tail)`` -> (``[B, 1,
    d]``, new state)."""
    h_prev, tail = state
    gate = F.gelu(dense(x, p.in_gelu), approximate="tanh")
    u = dense(x, p.in_rec)[:, 0]                             # [B, lru]
    window = torch.cat([tail, u[:, None]], dim=1)             # [B, K, lru]
    uc = _taps(p, window, 1)[:, 0]
    a, b = _gates(p, uc)
    h = a * h_prev + b
    y = gate.float()[:, 0] * h
    return dense(y.to(x.dtype), p.out)[:, None], (h, window[:, 1:])
