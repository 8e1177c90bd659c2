"""Physical page pool + per-sequence page tables (vLLM-style management).

A copy of ``repro.cache.paged_kv`` (numpy only) so the port imports nothing
of the JAX package.

The pool is a host-side free-list allocator over fixed-size physical pages
(page = 16 tokens = the finest AB-Sparse granularity, so the paper's
hierarchical-divisibility property holds for every candidate block size:
any logical block of size B maps to exactly B/16 physical pages).

``PageTable.physical_view(logical_page_table)`` performs the block->page
strided mapping of paper Fig. 9: selection produces *logical* page indices
per sequence; composing with the logical->physical map yields the indices
kernel 3 DMAs — one gather on a [B, H, P_sel] int32 table, no KV movement.

Pages are reference-counted so they can be shared across sequences: a new
request whose prompt shares a page-aligned prefix with an earlier one is
``fork``'d onto the donor's physical pages (refcount bump) and only its
divergent suffix gets fresh pages.  The radix prefix index
(:mod:`repro_torch.cache.prefix_cache`) holds its own reference on cached pages
via ``cache_ref`` so a retired donor's prefix stays reusable until evicted.
``ensure_owned`` is the copy-on-write primitive (migrate a sequence off a
shared page before a divergent write); the serving engine never hits it —
prefix matches are page-granular, so a sharer's writes always start past
the shared span — but any future writer into shared pages must call it.

Invariants (property-tested):
- refcount(p) == (#tables referencing p) + (1 if cache-pinned else 0),
- a page is in the free list iff refcount == 0 (and appears there once),
- logical->physical is injective per sequence,
- freeing a sequence only returns pages whose refcount drops to 0,
- allocation fails cleanly when the pool is exhausted (admission control).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np


class PoolExhausted(Exception):
    pass


@dataclass
class PageTable:
    """Per-sequence logical -> physical page mapping."""

    seq_id: int
    physical: List[int] = field(default_factory=list)  # index = logical page

    @property
    def n_pages(self) -> int:
        return len(self.physical)

    def physical_view(self, logical_pages: np.ndarray) -> np.ndarray:
        """Map logical page indices (any shape) to physical pool indices."""
        table = np.asarray(self.physical, dtype=np.int32)
        return table[np.asarray(logical_pages)]


class PagePool:
    """Refcounted free-list allocator over ``total_pages`` physical pages."""

    def __init__(self, total_pages: int, page_size: int = 16):
        self.total_pages = total_pages
        self.page_size = page_size
        self._free: List[int] = list(range(total_pages - 1, -1, -1))
        self._refcount: List[int] = [0] * total_pages
        self._tables: Dict[int, PageTable] = {}
        #: tokens actually stored per sequence (page occupancy can be
        #: partial; ``extend`` only allocates when a page boundary is hit).
        self._tokens: Dict[int, int] = {}
        #: pages pinned by the prefix cache (at most one pin per page).
        self._cache_pins: Set[int] = set()
        #: high-water mark of allocated pages — exit-time ``used_pages``
        #: hides transient overcommit (e.g. during preemption storms), so
        #: benches report this instead.
        self.peak_used_pages = 0
        #: optional ``callable(reason, need)`` fault-injection hook
        #: (:mod:`repro_torch.resilience`): raises :class:`PoolExhausted`
        #: before any allocation state mutates.  ``None`` (the default)
        #: leaves the allocator untouched.
        self.fault_hook = None

    # -- capacity ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.total_pages - self.free_pages

    def refcount(self, page: int) -> int:
        return self._refcount[page]

    def is_cache_pinned(self, page: int) -> bool:
        return page in self._cache_pins

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= self.free_pages

    def seq_tokens(self, seq_id: int) -> int:
        return self._tokens[seq_id]

    # -- allocation ----------------------------------------------------------

    def _take(self, need: int, reason: str) -> List[int]:
        """Pop ``need`` fresh pages (refcount 0 -> 1), all-or-nothing."""
        if self.fault_hook is not None and need > 0:
            self.fault_hook(reason, need)
        if need > len(self._free):
            raise PoolExhausted(
                f"{reason} needs {need} pages, only {len(self._free)} free"
            )
        pages = [self._free.pop() for _ in range(need)]
        for p in pages:
            self._refcount[p] = 1
        if self.used_pages > self.peak_used_pages:
            self.peak_used_pages = self.used_pages
        return pages

    def allocate(self, seq_id: int, n_tokens: int) -> PageTable:
        return self.fork(seq_id, (), n_tokens)

    def fork(
        self, seq_id: int, shared_pages: Sequence[int], n_tokens: int
    ) -> PageTable:
        """Create a table whose leading logical pages alias ``shared_pages``
        (refcount bump — the prefix-sharing path) and whose remainder is
        freshly allocated.  ``n_tokens`` is the total token span covered.
        With no shared pages this is a plain allocation."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        shared_tokens = len(shared_pages) * self.page_size
        if shared_tokens > n_tokens:
            raise ValueError(
                f"{len(shared_pages)} shared pages cover {shared_tokens} "
                f"tokens > requested span {n_tokens}"
            )
        need = self.pages_for(n_tokens) - len(shared_pages)
        fresh = self._take(need, "fork" if shared_pages else "allocate")
        for p in shared_pages:
            assert self._refcount[p] > 0, f"sharing dead page {p}"
            self._refcount[p] += 1
        table = PageTable(seq_id, list(shared_pages) + fresh)
        self._tables[seq_id] = table
        self._tokens[seq_id] = n_tokens
        return table

    def extend(self, seq_id: int, n_new_tokens: int) -> PageTable:
        """Grow a sequence's span by ``n_new_tokens``; pages are allocated
        only when the partially-filled last page cannot absorb them."""
        table = self._tables[seq_id]
        new_total = self._tokens[seq_id] + n_new_tokens
        need = self.pages_for(new_total) - table.n_pages
        if need > 0:
            table.physical.extend(self._take(need, "extend"))
        self._tokens[seq_id] = new_total
        return table

    def free(self, seq_id: int):
        """Release a sequence's references; pages return to the free list
        only when nobody else (another fork or the prefix cache) holds them."""
        table = self._tables.pop(seq_id)
        del self._tokens[seq_id]
        for p in table.physical:
            self._decref(p)
        table.physical.clear()

    def _decref(self, p: int):
        rc = self._refcount[p] - 1
        if rc < 0:
            raise AssertionError(f"page {p} refcount went negative")
        self._refcount[p] = rc
        if rc == 0:
            self._free.append(p)

    # -- copy-on-write -------------------------------------------------------

    def ensure_owned(self, seq_id: int, logical_page: int) -> Tuple[int, int]:
        """Copy-on-write: make ``logical_page`` exclusively owned before a
        write.  -> ``(old_phys, new_phys)``; equal when the page was already
        exclusive, otherwise the caller must copy the KV rows old -> new."""
        table = self._tables[seq_id]
        phys = table.physical[logical_page]
        if self._refcount[phys] == 1:
            return phys, phys
        [new] = self._take(1, "copy-on-write")
        table.physical[logical_page] = new
        self._decref(phys)
        return phys, new

    # -- prefix-cache pins ---------------------------------------------------

    def cache_ref(self, page: int):
        """The prefix cache takes a reference on ``page`` (idempotent is the
        caller's job: at most one pin per page)."""
        assert page not in self._cache_pins, f"page {page} already pinned"
        assert self._refcount[page] > 0, f"pinning dead page {page}"
        self._cache_pins.add(page)
        self._refcount[page] += 1

    def cache_unref(self, page: int):
        self._cache_pins.remove(page)
        self._decref(page)

    # -- introspection -------------------------------------------------------

    def table(self, seq_id: int) -> PageTable:
        return self._tables[seq_id]

    def owner_map(self) -> np.ndarray:
        """[total_pages] -> owner (debug/invariant checking): -1 free,
        -2 held only by the prefix cache, else the lowest-numbered owning
        sequence (shared pages have several owners)."""
        owner = np.full(self.total_pages, -1, np.int64)
        for p in self._cache_pins:
            owner[p] = -2
        for sid in sorted(self._tables):
            for p in self._tables[sid].physical:
                if owner[p] < 0:
                    owner[p] = sid
        return owner

    def assert_consistent(
        self, known_pins: Optional[Iterable[int]] = None
    ) -> List[int]:
        """Full accounting audit; raises AssertionError on any violation.

        The pin/refcount interaction gets its own explicit checks (a pinned
        page must carry its pin reference and never sit on the free list —
        previously such corruption only surfaced via the generic refcount
        mismatch, with a misleading message).  Returns *leak candidates*:
        pages whose only remaining reference is a cache pin that the pin
        owner no longer knows about.  Pass ``known_pins`` (the prefix
        cache's live page set, see ``PrefixCache.pages``) to cross-check;
        without it pin-only pages are legitimate cached prefixes and the
        candidate list is empty.
        """
        refs = [0] * self.total_pages
        for sid, t in self._tables.items():
            assert len(set(t.physical)) == len(t.physical), (
                f"seq {sid} page table not injective"
            )
            assert t.n_pages == self.pages_for(self._tokens[sid]), (
                f"seq {sid}: {t.n_pages} pages for {self._tokens[sid]} tokens"
            )
            for p in t.physical:
                refs[p] += 1
        for p in self._cache_pins:
            refs[p] += 1
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "free list has duplicates"
        for p in self._cache_pins:
            # a pin IS a reference: a pinned page with refcount 0 (or on the
            # free list) means someone freed it out from under the cache.
            assert self._refcount[p] >= 1, (
                f"page {p}: cache-pinned but refcount {self._refcount[p]}"
            )
            assert p not in free_set, (
                f"page {p}: cache-pinned but on the free list"
            )
        for p in range(self.total_pages):
            assert self._refcount[p] == refs[p], (
                f"page {p}: refcount {self._refcount[p]} != {refs[p]} refs"
            )
            assert (self._refcount[p] == 0) == (p in free_set), (
                f"page {p}: rc {self._refcount[p]} vs free-list membership"
            )
        if known_pins is None:
            return []
        known = set(known_pins)
        unknown = self._cache_pins - known
        assert not (known - self._cache_pins), (
            f"pin owner claims pages the pool never pinned: "
            f"{sorted(known - self._cache_pins)}"
        )
        # unknown pins whose only reference is the pin itself: nothing will
        # ever unpin them -> leaked pages.
        return sorted(p for p in unknown if self._refcount[p] == 1)
