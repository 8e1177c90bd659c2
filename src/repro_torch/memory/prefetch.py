"""Double-buffered host->HBM staging queue (a copy of
``repro.memory.prefetch``).

Promotions are *submitted* during tick ``t`` (after the decode step has
emitted its selection) and *applied* at the start of tick ``t+1``, before
anything reads the cache — so the copy window overlaps the host-side
scheduling work between ticks rather than sitting on the decode critical
path.  Two kinds:

- ``"miss"`` — a selection actually needed the page (the owning sequence
  is stalled on it).  Applied with demotion rights; re-queued if the
  demotion shield covers the whole HBM budget this tick.
- ``"predict"`` — the page ranked just below the selection cutoff (the
  margin of the previous step's top-K), so it is the likely target when
  selection drifts.  Applied only into free HBM headroom — speculation
  never demotes resident pages.
"""
from __future__ import annotations

from typing import List, Tuple


class PrefetchQueue:
    MISS, PREDICT = "miss", "predict"

    def __init__(self):
        self._staged: List[Tuple[int, str]] = []
        self.submitted_miss = 0
        self.submitted_predict = 0
        self.applied = 0
        self.skipped = 0

    def __len__(self) -> int:
        return len(self._staged)

    def submit(self, page: int, kind: str):
        assert kind in (self.MISS, self.PREDICT), kind
        if any(p == page for p, _ in self._staged):
            return
        self._staged.append((page, kind))
        if kind == self.MISS:
            self.submitted_miss += 1
        else:
            self.submitted_predict += 1

    def drain(self) -> List[Tuple[int, str]]:
        """Take the staged batch for application (misses first — they
        unblock a stalled sequence; predictions only fill leftover room)."""
        staged, self._staged = self._staged, []
        staged.sort(key=lambda e: e[1] != self.MISS)
        return staged

    def requeue(self, page: int, kind: str):
        """Put an entry back without recounting it as a new submission."""
        self._staged.append((page, kind))
