"""Attention recall, the paper's measure of block-selection quality
(counterpart of ``repro.core.recall``).

Recall(h) is the share of a head's attention probability mass that falls on
the tokens of its selected blocks; the calibration pass (Eq. 2) profiles it
per head and block size.
"""
from __future__ import annotations

import math

import torch


def attention_probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q ``[..., D]``, k ``[..., S, D]`` -> f32 softmax probabilities
    ``[..., S]``.  The logits are a broadcast multiply and a sum over the
    channels, so a row's value does not depend on how many rows are
    batched with it."""
    d = q.shape[-1]
    logits = (q.to(torch.float32)[..., None, :] * k.to(torch.float32)).sum(-1)
    return torch.softmax(logits / math.sqrt(d), dim=-1)


def recall_from_mask(probs: torch.Tensor, token_mask: torch.Tensor) -> torch.Tensor:
    """probs ``[..., S]``, token_mask ``[..., S]`` bool -> recall ``[...]``."""
    captured = (probs * token_mask.to(probs.dtype)).sum(-1)
    return captured / torch.clamp_min(probs.sum(-1), 1e-12)


def oracle_topk_mass(probs: torch.Tensor, budget: int) -> torch.Tensor:
    """Best recall a token budget allows (token-level oracle): the mass of
    the ``budget`` largest probabilities over the total."""
    top = torch.topk(probs, min(budget, probs.shape[-1]), dim=-1).values
    return top.sum(-1) / torch.clamp_min(probs.sum(-1), 1e-12)
