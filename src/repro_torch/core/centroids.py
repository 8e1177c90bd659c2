"""Rank keys / rank queries (counterpart of ``repro.core.centroids``).

Every centroid method's block score is one inner product
``dot(rank_query(q), rank_key(K_block))``:

- mean:    rq = q                      rk = mean(K)
- quest:   rq = [relu(q), -relu(-q)]   rk = [max(K), min(K)]
- arkvale: rq = [q, ||q||]             rk = [center, radius]

Widths are zero-padded to a multiple of 128 channels.  A rank key is
assembled from per-block statistics by :func:`rank_key_from_stats`, the one
definition shared by :func:`build_rank_keys` (raw keys, the calibration
pass and offline stores) and the decode store's page-statistics builder
(``repro_torch.backends.store``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LANE = 128
#: centroid methods, in the order of the pooling kernel's method codes
METHODS = ("mean", "quest", "arkvale")


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


def rank_key_from_stats(
    mx: torch.Tensor,              # [..., D] per-block channel max
    mn: torch.Tensor,              # [..., D] per-block channel min
    mean,                          # [..., D] per-block mean (method "mean")
    radius,                        # [...] bounding radius (method "arkvale")
    method: str,
    width: int,                    # output width (>= the logical width)
) -> torch.Tensor:
    """mean -> mean; quest -> [max, min]; arkvale -> [center, radius] with
    center = (max + min) / 2; zero-padded to ``width`` channels."""
    if method == "mean":
        rk = mean
    elif method == "quest":
        rk = torch.cat([mx, mn], dim=-1)
    elif method == "arkvale":
        rk = torch.cat([0.5 * (mx + mn), radius[..., None]], dim=-1)
    else:
        raise ValueError(f"unknown centroid method {method!r}")
    pad = width - rk.shape[-1]
    return F.pad(rk, (0, pad)) if pad else rk


def build_rank_keys(
    keys: torch.Tensor, block_size: int, method: str, pad: bool = True
) -> torch.Tensor:
    """Raw keys ``[..., S, D]`` -> f32 rank keys ``[..., S / block_size, D']``
    (lane-padded to ``Dp`` when ``pad``).  arkvale's radius covers the
    farthest key of the block from its center."""
    *lead, S, D = keys.shape
    if S % block_size:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"block size {block_size}")
    blocks = keys.reshape(*lead, S // block_size, block_size, D).to(torch.float32)
    mx, mn = blocks.amax(dim=-2), blocks.amin(dim=-2)
    mean = blocks.mean(dim=-2) if method == "mean" else None
    radius = None
    if method == "arkvale":
        center = 0.5 * (mx + mn)
        radius = ((blocks - center[..., None, :]) ** 2).sum(-1).amax(-1).sqrt()
    width = padded_rank_key_width(D, method) if pad else rank_key_width(D, method)
    return rank_key_from_stats(mx, mn, mean, radius, method, width)


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
