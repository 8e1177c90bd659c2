"""Query-centroid importance estimation (paper Kernel 1), plain PyTorch in
f32 (counterpart of ``repro.core.estimation``).

The scoring kernels (:mod:`repro_torch.kernels.centroid_score`, the fused
decode) compute the same contract; this module is the oracle the tests and
the recall benchmarks read.  Given per-sequence flattened rank keys
``[B, N_total, D']`` (a tensor, or a :class:`QuantizedTensor`) and rank
queries ``[B, n_q, D']``, it returns block scores in the padded per-head
view ``[B, H, max_blocks]``, ``NEG_INF`` in pad slots.  Under
``"kv_head"`` granularity the scores of a GQA group's query heads are
max-pooled onto their kv head, so a group shares its selected pages;
under ``"q_head"`` each query head keeps its own row over its kv head's
rank keys.
"""
from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import QuantizedTensor, dequantize
from repro_torch.core.ragged import RaggedLayout
from repro_torch.core.stacked import LayoutArrays, as_arrays

NEG_INF = -1e30


def estimate_scores(
    rank_q: torch.Tensor,
    rank_keys: Union[torch.Tensor, QuantizedTensor],
    layout: Union[RaggedLayout, LayoutArrays],
    n_kv_heads: int,
    granularity: str = "kv_head",
) -> torch.Tensor:
    """-> scores ``[B, n_kv_heads]`` (``"kv_head"``) or ``[B, n_q]``
    (``"q_head"``) ``x max_blocks``, f32, ``NEG_INF`` in pads."""
    la = layout if isinstance(layout, LayoutArrays) else as_arrays(
        layout, rank_q.device)
    if isinstance(rank_keys, QuantizedTensor):
        rank_keys = dequantize(rank_keys)
    rank_keys = rank_keys.to(torch.float32)
    rank_q = rank_q.to(torch.float32)
    B, n_q, Dp = rank_q.shape
    if rank_keys.shape[-1] != Dp:
        raise ValueError(f"rank keys {tuple(rank_keys.shape)} against rank "
                         f"queries of width {Dp}")
    g = n_q // n_kv_heads

    flat = torch.einsum("bqd,bnd->bqn", rank_q, rank_keys)   # [B, n_q, N]
    rows = la.scatter_rows.long()                              # [H, M]
    mask = la.pad_mask                                         # [H, M]
    if granularity == "kv_head":
        flat = flat.reshape(B, n_kv_heads, g, -1).amax(dim=2)  # [B, n_kv, N]
        picked = torch.gather(flat, 2, rows[None].expand(B, -1, -1))
        return torch.where(mask[None], picked, NEG_INF)
    if granularity == "q_head":
        kv_of_q = torch.arange(n_q, device=rank_q.device) // g
        picked = flat[:, torch.arange(n_q, device=rank_q.device)[:, None],
                      rows[kv_of_q]]
        return torch.where(mask[kv_of_q][None], picked, NEG_INF)
    raise ValueError(f"unknown granularity {granularity!r}")


def estimate_scores_dense_oracle(
    q: torch.Tensor,
    keys: torch.Tensor,
    layout: RaggedLayout,
    method: str,
    granularity: str = "kv_head",
) -> torch.Tensor:
    """The scores straight from raw keys (no flattened store): q
    ``[B, n_q, D]``, keys ``[B, n_kv, S, D]`` -> ``[B, H, max_blocks]``, one
    head's rank keys at a time, pads at ``NEG_INF``."""
    from repro_torch.core.centroids import build_rank_keys, rank_query

    B, n_kv, S, D = keys.shape
    g = q.shape[1] // n_kv
    rq = rank_query(q, method, D)                              # [B, n_q, Dp]
    per_head = []
    for h in range(n_kv):
        rk = build_rank_keys(keys[:, h], layout.block_sizes[h], method)
        s = torch.einsum("bqd,bnd->bqn", rq[:, h * g:(h + 1) * g], rk)
        if granularity == "kv_head":
            s = s.amax(dim=1)                                  # [B, nb]
        per_head.append(F.pad(s, (0, layout.max_blocks - s.shape[-1]),
                              value=NEG_INF))
    return torch.stack(per_head, dim=1)
