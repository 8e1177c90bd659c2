"""RWKV-6 ("Finch") time mixing with data-dependent decay, counterpart of
``repro.models.rwkv6``.

Per head (head_dim ``N``), per token:

  S_t = diag(w_t) S_{t-1} + k_t^T v_t                 state [N, N]
  o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)              (bonus u on the token)

with the decay ``w_t = exp(-exp(ww x_t^w + w_bias))`` and token-shift mixing
(a lerp of each token with the one before it) on r / k / v / w / g; the
output is ``wo(rms_norm(o * silu(g)))``.

The projections do not depend on the state, so prefill runs them over all
tokens at once.  The recurrence then runs over time in chunks of
``CHUNK`` tokens, in f32: inside every chunk at once in closed form (each
pair of tokens decays by ``exp`` of the difference of the cumulative log
decays, at most 1, so nothing overflows), then the ``[B, H, N, N]`` state
carried from chunk to chunk, one update a chunk; the output and the final
state ``(S, x_prev)`` come from the one pass.  Decode is JAX's O(1) step.

The weights are a :class:`~repro_torch.models.layers.DecoderLayer`'s
(``mu`` f32 ``[5, d]``, ``wr``, ``wk``, ``wv``, ``wg``, ``ww``, ``w_bias``
f32, ``u`` f32, ``wo``, ``ln_x``), in JAX's ``[d_in, d_out]`` layout.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, rms_norm

#: tokens per chunk of the prefill recurrence, and the most pair entries
#: (chunks x heads x chunk^2 x head_dim) it holds at once
CHUNK, PAIR_ELEMS = 16, 1 << 26


def init_state(cfg, batch: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero state: ``S [B, H, N, N]`` f32 and ``x_prev [B, d]`` in the model
    dtype."""
    N = cfg.rwkv_head_dim
    H = cfg.d_model // N
    return (torch.zeros((batch, H, N, N), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.d_model), dtype=dtype, device=device))


def _projections(p, x: torch.Tensor, x_prev: torch.Tensor, N: int):
    """x, x_prev ``[..., d]`` -> r, k, v, g ``[..., H, N]`` in the model
    dtype and the log decay ``log w`` ``[..., H, N]`` in f32."""
    mu = p.mu
    shape = x.shape[:-1] + (x.shape[-1] // N, N)
    xf, dx = x.float(), x_prev.float() - x.float()

    def proj(i, w):
        # the lerp in f32 (XLA keeps JAX's bf16 difference in f32 too)
        return dense((xf + dx * mu[i]).to(x.dtype), w)

    r, k, v = proj(0, p.wr), proj(1, p.wk), proj(2, p.wv)
    logw = -torch.exp(proj(3, p.ww).float() + p.w_bias)
    g = F.silu(proj(4, p.wg))
    return (r.reshape(shape), k.reshape(shape), v.reshape(shape),
            g.reshape(shape), logw.reshape(shape))


def _output(p, y: torch.Tensor, g: torch.Tensor, dtype) -> torch.Tensor:
    """o ``[..., H, N]`` f32 gated by g -> ``wo(rms_norm(.))`` ``[..., d]``."""
    y = (y * g.float()).flatten(-2)
    return dense(rms_norm(y.to(dtype), p.ln_x, 1e-5), p.wo)


def wkv_chunked(r, k, v, logw, u, S0, chunk: int = CHUNK):
    """The wkv recurrence over ``[B, T, H, N]`` f32 inputs from state ``S0``
    ``[B, H, N, N]`` -> (o ``[B, T, H, N]``, final state).  Tokens go in
    chunks of ``chunk``: the pairs inside each chunk for all chunks at once
    (in groups of chunks of at most ``PAIR_ELEMS`` pair entries), then the
    state carried from chunk to chunk, then each chunk's reads of the
    state it started from."""
    B, T, H, N = r.shape
    pad = -T % chunk
    if pad:                 # decay 1 and no input past the end: S unchanged
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, logw))
    nC = (T + pad) // chunk

    def blocks(t):          # [B, nC, H, L, N]
        return t.reshape(B, nC, chunk, H, N).transpose(2, 3)

    r, k, v, logw = blocks(r), blocks(k), blocks(v), blocks(logw)
    c = torch.cumsum(logw, dim=3)                           # through token t
    cp = c - logw                                           # through t - 1
    last = c[:, :, :, -1:]                                  # [B, nC, H, 1, N]
    # the token's own bonus, then pairs s < t: r_t . k_s decayed from s to t - 1
    o = (r * u.reshape(H, 1, N) * k).sum(-1, keepdim=True) * v
    strict = torch.ones((chunk, chunk), dtype=torch.bool, device=r.device).tril(-1)
    step = max(1, PAIR_ELEMS // (B * H * chunk * chunk * N))
    for i in range(0, nC, step):
        sl = slice(i, i + step)
        dec = torch.exp(torch.where(strict[..., None],
                                    cp[:, sl, :, :, None] - c[:, sl, :, None], -torch.inf))
        att = (dec * r[:, sl, :, :, None] * k[:, sl, :, None]).sum(-1)   # [B, g, H, L, L]
        o[:, sl] += att @ v[:, sl]
    # the state each chunk starts from
    kv = (k * torch.exp(last - c)).transpose(-1, -2) @ v    # [B, nC, H, N, N]
    decay = torch.exp(last).transpose(-1, -2)               # [B, nC, H, N, 1]
    starts, S = [], S0
    for i in range(nC):
        starts.append(S)
        S = torch.addcmul(kv[:, i], decay[:, i], S)
    o = o + (r * torch.exp(cp)) @ torch.stack(starts, dim=1)
    return o.transpose(2, 3).reshape(B, nC * chunk, H, N)[:, :T], S


def rwkv_time_mix(p, x: torch.Tensor, cfg):
    """Full sequence from the zero state: ``x [B, T, d]`` -> (``[B, T, d]``,
    final state ``(S [B, H, N, N] f32, x_prev [B, d])``)."""
    N = cfg.rwkv_head_dim
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, logw = _projections(p, x, x_prev, N)
    B, T, H, _ = r.shape
    S0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
    o, S = wkv_chunked(r.float(), k.float(), v.float(), logw, p.u, S0)
    return _output(p, o, g, x.dtype), (S, x[:, -1])


def rwkv_decode(p, x: torch.Tensor, state, cfg):
    """One token: ``x [B, 1, d]``, state ``(S, x_prev)`` -> (``[B, 1, d]``,
    new state), JAX's ``_step``."""
    S, x_prev = state
    xt = x[:, 0]
    r, k, v, g, logw = _projections(p, xt, x_prev, cfg.rwkv_head_dim)
    H, N = r.shape[1:]
    kv = k.float()[..., :, None] * v.float()[..., None, :]        # [B, H, N, N]
    att = S + p.u.reshape(H, N, 1) * kv
    o = torch.einsum("bhn,bhnm->bhm", r.float(), att)
    S_new = torch.exp(logw)[..., None] * S + kv
    return _output(p, o, g, x.dtype)[:, None], (S_new, xt)
