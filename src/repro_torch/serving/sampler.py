"""Top-k / top-p / temperature sampling (counterpart of
``repro.serving.sampler``).

At ``temperature <= 0`` sampling is ``argmax`` with the first index winning
ties, exactly as in the JAX package.  At ``temperature > 0`` each row draws
from its own ``torch.Generator`` seeded from ``(seed, seq_id, position)``,
so a token depends only on its sequence and position, never on the batch
or the tick schedule (JAX's ``fold_in`` key stream cannot be reproduced in
PyTorch; the distributions agree, the draws do not).

Hardened against non-finite logits: :func:`finite_mask` is the detector
and :func:`guarded_sample` raises a typed :class:`SamplerAnomaly` (which the
engine catches) instead of sampling.  A NaN row must
never reach :func:`sample` at ``temperature > 0``: ``torch.multinomial``
raises a bare ``RuntimeError`` on it (JAX's ``categorical`` returns a
token), so the engine samples only the finite rows.
"""
from __future__ import annotations

from typing import Sequence

import torch


class SamplerAnomaly(RuntimeError):
    """Non-finite logits reached the sampler.  Carries the implicated
    ``seq_ids`` so the engine restores exactly the poisoned sequences and
    commits the rest of the batch.  ``injected`` marks rows that a fault
    injector poisoned: only those may move the degradation ladder."""

    def __init__(self, seq_ids: Sequence[int], detail: str = "",
                 injected: bool = False):
        self.seq_ids = list(seq_ids)
        self.injected = injected
        msg = f"non-finite logits for sequences {self.seq_ids}"
        super().__init__(f"{msg} ({detail})" if detail else msg)


def finite_mask(logits: torch.Tensor) -> torch.Tensor:
    """Per-row all-finite mask: ``[B, V] -> [B]`` bool."""
    return torch.isfinite(logits).all(dim=-1)


def guarded_sample(
    logits: torch.Tensor,          # [B, V]
    seq_ids: Sequence[int],
    positions: Sequence[int],
    temperature: float = 0.6,
    top_k: int = 20,
    top_p: float = 0.95,
    seed: int = 0,
) -> torch.Tensor:
    """:func:`sample`, but raise :class:`SamplerAnomaly` naming the
    sequences of the non-finite rows instead of sampling them."""
    bad = torch.nonzero(~finite_mask(logits)).flatten().tolist()
    if bad:
        raise SamplerAnomaly([seq_ids[i] for i in bad],
                             detail=f"{len(bad)} poisoned rows")
    return sample(logits, seq_ids, positions, temperature, top_k, top_p, seed)


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
