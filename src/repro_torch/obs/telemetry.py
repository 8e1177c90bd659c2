"""Sparsity telemetry aggregation (counterpart of ``repro.obs.telemetry``).

The decode step fills one ``[n_layers, B, 4]`` int32 tensor per tick (see
``Transformer.decode_step``) with, per attention layer and batch slot:

- ``BLOCKS``: variable-size blocks selected for attention this step,
- ``PAGES``:  KV page gathers those blocks map to, summed per head (each
  head reads its own pages, so this is the attention stage's read volume),
- ``FORCED``: selected blocks that were *pinned* (sink/local) rather than
  chosen by score ranking,
- ``BUDGET``: the layer's total top-K block budget (selection capacity).

Sparse prefill similarly fills per-layer attended-block counts.  The engine
copies each to the host once per decode tick / prefill chunk.

:class:`SparsityAggregate` folds those per-step arrays into run-level
statistics (totals, budget-utilization histogram) that
``ServingMetrics.snapshot()`` surfaces.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

#: column indices of the per-layer decode telemetry array.
BLOCKS, PAGES, FORCED, BUDGET = range(4)
N_COUNTERS = 4


class SparsityAggregate:
    """Streaming aggregation of per-step, per-layer sparsity counters."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self.layer_sums = np.zeros((n_layers, N_COUNTERS), dtype=np.int64)
        self.steps = 0                  # decode steps folded in
        self.slot_steps = 0             # (step, live slot) pairs folded in
        # budget-utilization deciles over (step, slot) pairs: hist[d] counts
        # pairs with utilization in [d/10, (d+1)/10); the last bin is closed.
        self.util_hist = np.zeros(10, dtype=np.int64)
        self.prefill_attended = np.zeros(n_layers, dtype=np.int64)
        self.prefill_candidates = np.zeros(n_layers, dtype=np.int64)
        self.prefill_chunks = 0
        # per-tick arrays queued by update_decode and folded lazily at
        # snapshot time, off the latency-critical decode tick.
        self._pending: List = []

    # -- folding -------------------------------------------------------------

    def update_decode(self, tel: np.ndarray, slots: Sequence[int]):
        """Queue one decode tick (folded lazily — see ``_fold``).

        ``tel`` is a fresh host copy of the ``[n_layers, B, 4]`` counter
        tensor (kept as is until folded, so it must not alias a buffer the
        next step overwrites); ``slots`` lists the batch slots that actually
        decoded this tick (empty slots carry stale/zero telemetry and must
        not be counted).
        """
        if not len(slots):
            return
        assert tel.shape[0] == self.n_layers and tel.shape[2] == N_COUNTERS, tel.shape
        self._pending.append((tel, list(slots)))

    def _fold(self):
        for tel, slots in self._pending:
            live = tel[:, slots, :]                          # [L, S, 4]
            self.layer_sums += live.sum(axis=1, dtype=np.int64)
            self.steps += 1
            self.slot_steps += len(slots)
            budget = live[:, :, BUDGET].astype(np.float64)
            util = np.where(
                budget > 0, live[:, :, BLOCKS] / np.maximum(budget, 1), 0.0
            ).mean(axis=0)                                   # [S] layer-mean
            bins = np.minimum((util * 10).astype(np.int64), 9)
            np.add.at(self.util_hist, bins, 1)
        self._pending.clear()

    def update_prefill(self, attended: np.ndarray,
                       candidates: Optional[np.ndarray] = None):
        """Fold one prefill chunk: per-layer attended block counts plus
        (host-computed) causal candidate counts for the same chunk."""
        self.prefill_attended += np.asarray(attended, dtype=np.int64)
        if candidates is not None:
            self.prefill_candidates += np.asarray(candidates, dtype=np.int64)
        self.prefill_chunks += 1

    # -- reporting -----------------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        self._fold()
        tot = self.layer_sums.sum(axis=0)                   # [4]
        s = max(self.steps, 1)
        out = {
            "sparsity_steps": float(self.steps),
            "blocks_per_step": float(tot[BLOCKS]) / s,
            "pages_per_step": float(tot[PAGES]) / s,
            "budget_utilization": (
                float(tot[BLOCKS]) / float(tot[BUDGET]) if tot[BUDGET] else 0.0
            ),
            "forced_frac": (
                float(tot[FORCED]) / float(tot[BLOCKS]) if tot[BLOCKS] else 0.0
            ),
            "prefill_chunks": float(self.prefill_chunks),
            "prefill_blocks_attended": float(self.prefill_attended.sum()),
            "prefill_blocks_frac": (
                float(self.prefill_attended.sum())
                / float(self.prefill_candidates.sum())
                if self.prefill_candidates.sum() else 0.0
            ),
        }
        if self.slot_steps:
            out["budget_util_hist"] = [
                float(c) / self.slot_steps for c in self.util_hist
            ]
        return out


def prefill_block_candidates(
    layouts, chunk_offset: int, n_tokens: int, block_q: int
) -> np.ndarray:
    """Per-layer causal candidate-block counts for one prefill chunk.

    For each query block of the chunk (size ``block_q``, absolute positions
    ``chunk_offset .. chunk_offset + n_tokens``) a head with block size
    ``B_h`` over an ``S``-token context exposes at most
    ``min(q_end // B_h + 1, S // B_h)`` causally visible key blocks.
    Summed over query blocks and heads this is the denominator for the
    realized prefill sparsity fraction (the kernel reports the numerator).
    """
    n_qb = max((n_tokens + block_q - 1) // block_q, 1)
    q_ends = chunk_offset + np.minimum(
        (np.arange(n_qb) + 1) * block_q, n_tokens
    ) - 1                                                    # [nQB] absolute
    out = np.zeros(len(layouts), dtype=np.int64)
    for li, lay in enumerate(layouts):
        per_head = 0
        for h, bs in enumerate(lay.block_sizes):
            nb = int(lay.n_blocks[h])
            per_head += int(np.minimum(q_ends // int(bs) + 1, nb).sum())
        out[li] = per_head
    return out
