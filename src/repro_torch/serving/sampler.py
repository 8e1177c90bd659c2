"""Top-k / top-p / temperature sampling (counterpart of
``repro.serving.sampler``).

At ``temperature <= 0`` sampling is ``argmax`` with the first index winning
ties, exactly as in the JAX package.  At ``temperature > 0`` each row draws
from its own ``torch.Generator`` seeded from ``(seed, seq_id, position)``,
so a token depends only on its sequence and position, never on the batch
or the tick schedule (JAX's ``fold_in`` key stream cannot be reproduced in
PyTorch; the distributions agree, the draws do not).
"""
from __future__ import annotations

from typing import Sequence

import torch


class SamplerAnomaly(RuntimeError):
    """Non-finite logits reached the sampler."""

    def __init__(self, seq_ids: Sequence[int], detail: str = ""):
        self.seq_ids = list(seq_ids)
        msg = f"non-finite logits for sequences {self.seq_ids}"
        super().__init__(f"{msg} ({detail})" if detail else msg)


def finite_mask(logits: torch.Tensor) -> torch.Tensor:
    """Per-row all-finite mask: ``[B, V] -> [B]`` bool."""
    return torch.isfinite(logits).all(dim=-1)


def _row_seed(seed: int, seq_id: int, pos: int) -> int:
    return ((seed * 1_000_003 + seq_id) * 1_000_033 + pos) & ((1 << 63) - 1)


def sample(
    logits: torch.Tensor,          # [B, V]
    seq_ids: Sequence[int],
    positions: Sequence[int],
    temperature: float = 0.6,
    top_k: int = 20,
    top_p: float = 0.95,
    seed: int = 0,
) -> torch.Tensor:
    """-> [B] int64 token ids."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    V = logits.shape[-1]
    if top_k and top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, -1e30)
    if top_p < 1.0:
        # keep the smallest sorted prefix whose mass reaches top_p
        order = torch.argsort(-logits, dim=-1, stable=True)
        sorted_logits = torch.gather(logits, -1, order)
        probs = torch.softmax(sorted_logits, dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep_sorted[..., 0] = True
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        logits = torch.where(keep, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.empty(logits.shape[0], dtype=torch.int64, device=logits.device)
    for i, (sid, pos) in enumerate(zip(seq_ids, positions)):
        g = torch.Generator(device=logits.device)
        g.manual_seed(_row_seed(seed, int(sid), int(pos)))
        out[i] = torch.multinomial(probs[i], 1, generator=g)[0]
    return out
