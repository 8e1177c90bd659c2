"""Rank keys / rank queries (counterpart of ``repro.core.centroids``).

Every centroid method's block score is one inner product
``dot(rank_query(q), rank_key(K_block))``:

- mean:    rq = q                      rk = mean(K)
- quest:   rq = [relu(q), -relu(-q)]   rk = [max(K), min(K)]
- arkvale: rq = [q, ||q||]             rk = [center, radius]

Widths are zero-padded to a multiple of 128 channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LANE = 128


def rank_key_width(head_dim: int, method: str) -> int:
    if method == "mean":
        return head_dim
    if method == "quest":
        return 2 * head_dim
    if method == "arkvale":
        return head_dim + 1
    raise ValueError(f"unknown centroid method {method!r}")


def padded_rank_key_width(head_dim: int, method: str) -> int:
    w = rank_key_width(head_dim, method)
    return ((w + LANE - 1) // LANE) * LANE


def rank_query(q: torch.Tensor, method: str, head_dim: int) -> torch.Tensor:
    """queries ``[..., D]`` -> f32 rank queries ``[..., Dp]``."""
    q = q.to(torch.float32)
    if method == "mean":
        rq = q
    elif method == "quest":
        rq = torch.cat([torch.clamp_min(q, 0.0), torch.clamp_max(q, 0.0)], dim=-1)
    elif method == "arkvale":
        norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        rq = torch.cat([q, norm], dim=-1)
    else:
        raise ValueError(f"unknown centroid method {method!r}")
    pad = padded_rank_key_width(head_dim, method) - rq.shape[-1]
    return F.pad(rq, (0, pad)) if pad else rq
