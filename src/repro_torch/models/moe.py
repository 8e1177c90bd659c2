"""Mixture-of-Experts FFN with top-k routing (counterpart of
``repro.models.moe.moe_ffn`` with ``impl="einsum"``, the path JAX serves).

Capacity-based dispatch: the ``T`` tokens are split into ``G`` groups of
``gt``; in each group every (token, k) pick takes the next free place in
its expert's queue of ``C`` places (token-major, then k), and a pick past
the queue is dropped (it adds nothing; the token's other weights are not
renormalised).  The experts run as batched products over ``[E, G * C,
d]``.  JAX dispatches and combines by one-hot einsums; here a scatter puts
each kept token in its place (the same rows: a one-hot product copies a
row exactly) and a gather reads it back, weighted by the router's
probabilities cast to the activation dtype, as JAX casts its combine
tensor.

Every shape, ``C`` included, is a Python int of the input's shape, and no
step reads a tensor on the host, so the FFN stays inside a captured decode
step (``serving/graphs.py``).  The expert products are ``torch.bmm``; the
JAX package has no Pallas kernel here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def groups(T: int, group_size: int) -> Tuple[int, int]:
    """-> (G, gt): JAX's ``G = max(1, T // group_size)`` groups of ``gt =
    T // G`` tokens.  JAX reshapes ``[T, d]`` to ``[G, gt, d]``, which
    fails unless ``G`` divides ``T``; so does this."""
    G = max(1, T // group_size)
    if T % G:
        raise ValueError(
            f"moe_ffn: {T} tokens do not split into {G} groups of equal size "
            f"(G = max(1, T // group_size {group_size}) must divide T)")
    return G, T // G


def capacity(gt: int, n_experts: int, k: int, capacity_factor: float) -> int:
    """Places per expert and group: JAX's ``int(cf * gt * K / E)``, at least
    1 and ``min(gt, 8)`` (tiny decode groups), at most ``gt``."""
    C = max(1, int(capacity_factor * gt * k / n_experts))
    C = max(C, min(gt, 8))
    return min(C, gt)


def route(router_w: torch.Tensor, xg: torch.Tensor, k: int):
    """Router in f32: softmax over the experts, top-``k`` with
    ``lax.top_k``'s order (largest first, the lower expert index first
    among equal probabilities: a stable descending sort), weights
    renormalised by ``max(sum, 1e-9)``.  xg ``[G, gt, d]`` -> (weights
    ``[G, gt, k]`` f32, expert ids ``[G, gt, k]`` int64, probabilities
    ``[G, gt, E]``)."""
    logits = torch.matmul(xg.to(torch.float32), router_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return top_p, top_e, probs


def expert_positions(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Place of each (token, k) pick in its expert's queue: the picks of the
    same expert before it in token-major, then-k order.  ``[G, gt, k]``."""
    G, gt, k = top_e.shape
    flat = top_e.reshape(G, gt * k)
    # one-hot by comparison: F.one_hot reads the ids' range on the host
    experts = torch.arange(n_experts, device=top_e.device)
    onehot = (flat[..., None] == experts).to(torch.int32)  # [G, gt*k, E]
    before = torch.cumsum(onehot, dim=1) - 1
    return before.gather(2, flat[..., None]).reshape(G, gt, k)


def aux_loss(probs: torch.Tensor, top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch's load-balancing loss from one call's routing (JAX's
    ``_router``): ``E * sum_e(mean_probs_e * mean_picks_e) / K`` over the
    ``[G, gt]`` tokens, the probabilities ``[G, gt, E]`` and the picks
    ``[G, gt, K]`` that :func:`moe_ffn` hands back in ``routing`` -> f32
    scalar (the picks carry no gradient)."""
    k = top_e.shape[-1]
    experts = torch.arange(n_experts, device=top_e.device)
    picks = (top_e[..., None] == experts).to(torch.float32).sum(dim=2)
    me = probs.mean(dim=(0, 1))
    ce = picks.mean(dim=(0, 1))
    return n_experts * torch.sum(me * ce) / k


def _experts(layer, xe: torch.Tensor, activation: str) -> torch.Tensor:
    """xe ``[E, N, d]`` -> ``[E, N, d]`` through each expert's MLP (JAX's
    four activations, GELU in its tanh form)."""
    up = torch.bmm(xe, layer.up)
    if activation == "swiglu":
        h = F.silu(torch.bmm(xe, layer.gate)) * up
    elif activation == "geglu":
        h = F.gelu(torch.bmm(xe, layer.gate), approximate="tanh") * up
    elif activation == "relu2":
        h = torch.square(F.relu(up))
    elif activation == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(activation)
    return torch.bmm(h, layer.down)


def moe_ffn(
    layer,
    x: torch.Tensor,                # [B, S, d]
    cfg,
    group_size: int = 512,
    n_tokens: Optional[int] = None,
    routing: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """-> ``[B, S, d]`` in x's dtype.  ``layer`` holds ``router`` (f32 ``[d,
    E]``), ``up`` / ``gate`` (``[E, d, ff]``; ``gate`` for a gated
    activation) and ``down`` (``[E, ff, d]``).

    ``n_tokens`` is the token count of JAX's call when x holds only its
    first rows (a prefill chunk's live tokens out of its buffer): groups
    and capacity come from it, and the missing rows, which come last in
    the queues' order and so displace no live token, are zeros.  When
    ``routing`` is a dict it receives the picks: ``experts``, ``positions``
    and ``kept`` ``[G, gt, k]`` and ``probs`` ``[G, gt, E]``."""
    moe = cfg.moe
    E, K = moe.n_experts, moe.experts_per_token
    B, S, d = x.shape
    T = B * S if n_tokens is None else n_tokens
    if T < B * S:
        raise ValueError(f"moe_ffn: n_tokens {T} < the {B * S} rows given")
    G, gt = groups(T, group_size)
    C = capacity(gt, E, K, moe.capacity_factor)
    xt = x.reshape(B * S, d)
    if T > B * S:
        xt = torch.cat([xt, xt.new_zeros((T - B * S, d))])
    xg = xt.reshape(G, gt, d)
    top_p, top_e, probs = route(layer.router, xg, K)
    pos = expert_positions(top_e, E)
    kept = pos < C
    slot = torch.where(kept, pos, C)                       # C: dropped
    gidx = torch.arange(G, device=x.device)[:, None, None].expand(G, gt, K)
    # dispatch: each kept pick's token row in its expert's place (row C
    # takes the dropped picks and is cut off)
    xe = x.new_zeros((G, E, C + 1, d))
    xe.index_put_((gidx, top_e, slot), xg[:, :, None, :].expand(G, gt, K, d))
    xe = xe[:, :, :C].transpose(0, 1).reshape(E, G * C, d)
    ye = _experts(layer, xe, cfg.activation)               # [E, G*C, d]
    ye = ye.reshape(E, G, C, d).transpose(0, 1)
    ye = torch.cat([ye, ye.new_zeros((G, E, 1, d))], dim=2)
    # combine: each pick's expert row, weighted in the activation dtype
    picked = ye[gidx, top_e, slot]                         # [G, gt, K, d]
    w = torch.where(kept, top_p, 0.0).to(ye.dtype)
    y = (picked.to(torch.float32) * w.to(torch.float32)[..., None]).sum(2)
    if routing is not None:
        routing.update(experts=top_e, positions=pos, kept=kept, probs=probs)
    return y.reshape(T, d)[:B * S].reshape(B, S, d).to(x.dtype)
