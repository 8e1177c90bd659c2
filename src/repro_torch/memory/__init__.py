"""Tiered KV memory (counterpart of ``repro.memory``): device-hot scoring
state, host-offloaded cold pages.

AB-Sparse decode touches only the selected KV blocks, so the full paged KV
cache does not need to be device-resident: only the compact quantized
centroid store and the page tables do.  This package tiers full KV pages
between a device budget (``ServeConfig.hbm_pages``) and a pinned host
spill store (``ServeConfig.host_pages``) under an LRU-by-last-selected-step
policy:

- :class:`TieredPagePool`: accounting: per-page tier state, budgets,
  protection (active working sets are never evicted), and the demotion /
  promotion policy.  Pure host-side; byte movement is delegated to
  callbacks.
- :class:`CachePageIO`: the byte mover: per-page gather / poison / restore,
  in place over the engine's device cache.
- :class:`PrefetchQueue`: double-buffered staging: promotions submitted at
  tick ``t`` (misses, plus pages predicted by the margin of the previous
  selection) apply at the start of tick ``t + 1``.
- :class:`MemoryManager`: glues the above to the serving engine: per-tick
  protection refresh, miss detection (stall only the owning sequence,
  re-run its step once the pages land), and prefetch bookkeeping.

The engine's device cache stays slot-contiguous and full-size, as JAX's
does: the device budget is an accounting limit, not a smaller tensor.
"""
from repro_torch.memory.manager import MemoryManager
from repro_torch.memory.page_io import POISON, CachePageIO
from repro_torch.memory.prefetch import PrefetchQueue
from repro_torch.memory.tiered_pool import (
    FREE, HBM, HOST, SNAPSHOT, TieredPagePool,
)

__all__ = [
    "CachePageIO", "FREE", "HBM", "HOST", "MemoryManager", "POISON",
    "PrefetchQueue", "SNAPSHOT", "TieredPagePool",
]
