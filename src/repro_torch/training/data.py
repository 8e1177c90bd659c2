"""Deterministic synthetic LM data (counterpart of ``repro.training.data``).

Every batch is a pure function of (seed, step, shard), drawn by numpy's
generator exactly as JAX's pipeline draws it, so the tokens are JAX's bit
for bit: restarts and re-sharding replay the same batches.  Token streams
are Zipf-distributed with copy (induction) structure, so small models
learn (the loss falls well below ln V).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_period: int = 64   # induction structure: token repeats with period


def batch_for_step(cfg: DataConfig, step: int, shard: int = 0, n_shards: int = 1,
                   device="cuda") -> torch.Tensor:
    """-> tokens ``[global_batch // n_shards, seq_len]`` int32 of this shard,
    on ``device``."""
    if cfg.global_batch % n_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split into "
                         f"{n_shards} shards")
    local = cfg.global_batch // n_shards
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, shard]))
    ranks = rng.zipf(cfg.zipf_a, size=(local, cfg.seq_len)).astype(np.int64)
    toks = (ranks - 1) % max(cfg.vocab_size - 2, 1) + 2  # reserve 0/1
    # induction structure: second half of each period copies the first half
    p = cfg.copy_period
    if cfg.seq_len >= 2 * p:
        for i in range(cfg.seq_len // (2 * p)):
            a = 2 * p * i
            toks[:, a + p: a + 2 * p] = toks[:, a: a + p]
    toks = np.minimum(toks, cfg.vocab_size - 1).astype(np.int32)
    return torch.from_numpy(toks).to(resolve_device(device))


class DataIterator:
    """Stateful wrapper with explicit (step, shard) bookkeeping for the
    training loop; checkpointable by the step counter alone."""

    def __init__(self, cfg: DataConfig, n_shards: int = 1, shard: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.n_shards = n_shards
        self.shard = shard
        self.device = resolve_device(device)
        self.step = 0

    def next(self) -> torch.Tensor:
        b = batch_for_step(self.cfg, self.step, self.shard, self.n_shards, self.device)
        self.step += 1
        return b

    def seek(self, step: int):
        self.step = step
