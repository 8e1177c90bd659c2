"""Tiered page pool: HBM-budgeted KV pages with host-tier spill.

A copy of ``repro.memory.tiered_pool`` (numpy only) over the port's own
:class:`~repro_torch.cache.paged_kv.PagePool`, so the port imports nothing
of the JAX package.

:class:`TieredPagePool` extends the refcounted :class:`~repro_torch.cache.
paged_kv.PagePool` with a per-page *tier*:

- ``FREE`` — refcount 0, on the free list.
- ``HBM`` — every live owner's device slot rows hold valid KV bytes.
  Charged to the HBM budget.
- ``HOST`` — demoted: bytes live in the host spill store, every live
  owner's device rows are poisoned.  Charged to the host budget.
- ``SNAPSHOT`` — held only by a prefix-cache pin, no live owners (so no
  device rows at all — the engine's device storage is per-slot).  Bytes
  live in the radix cache's own KV snapshots, which predate this
  subsystem, so the page is charged to *neither* budget.

Policy:

- Fresh pages are taken HBM-resident; when the HBM budget is full, the
  coldest eligible resident page (LRU by last-selected decode step) is
  demoted to the host tier first.
- *Protected* pages (the engine registers active decode working sets,
  every page of a prefilling sequence, and in-flight stall targets;
  freshly allocated or promoted pages are auto-protected until the next
  protection refresh) are never demoted — so live KV bytes are never
  poisoned out from under a reader.  A prefix-cache pin does NOT block
  demotion: the pin guarantees *reusability*, and the radix cache holds
  its own KV snapshot (taken at insert, under prefill protection)
  that reinstalls are copied from — demoting a pinned page loses nothing.
- ``fork`` promotes demoted/snapshotted shared pages back to HBM before
  taking fresh ones, restoring the other owners' device rows.
- A page whose last live owner frees it becomes ``SNAPSHOT`` when pinned
  (host copy dropped — the radix snapshot already holds the bytes), else
  ``FREE``.

Byte movement is delegated: the pool fires ``on_demote(page, owners)`` /
``on_promote(page, owners, from_tier)`` / ``on_drop_host(page)`` callbacks
(see :class:`~repro_torch.memory.manager.MemoryManager`); with no callbacks
registered it is a pure accounting object, which is what the property
tests exercise.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.cache.paged_kv import PagePool, PageTable, PoolExhausted

FREE, HBM, HOST, SNAPSHOT = "free", "hbm", "host", "snapshot"

#: owners of a page at migration time: ``(seq_id, logical_page)`` pairs.
Owners = List[Tuple[int, int]]


class TieredPagePool(PagePool):
    def __init__(self, hbm_pages: int, host_pages: int, page_size: int = 16):
        if hbm_pages <= 0:
            raise ValueError(f"hbm_pages must be positive, got {hbm_pages}")
        if host_pages < 0:
            raise ValueError(f"host_pages must be >= 0, got {host_pages}")
        super().__init__(hbm_pages + host_pages, page_size=page_size)
        self.hbm_pages = hbm_pages
        self.host_pages = host_pages
        self._tier: List[str] = [FREE] * self.total_pages
        #: page -> {seq_id: logical_page} for live references.
        self._owners: Dict[int, Dict[int, int]] = {}
        #: LRU stamp: last decode step whose selection touched the page.
        self._last_used: Dict[int, int] = {}
        self._clock = 0
        #: engine-registered demotion shield, replaced wholesale each tick.
        self._protected: set = set()
        #: pages allocated/promoted since the last ``set_protected`` — their
        #: bytes may not be installed yet, so they must survive until the
        #: engine's next protection refresh covers them.
        self._auto_protected: set = set()
        self._on_demote: Optional[Callable[[int, Owners], None]] = None
        self._on_promote: Optional[Callable[[int, Owners, str], None]] = None
        self._on_drop_host: Optional[Callable[[int], None]] = None
        self.hbm_used = 0
        self.host_used = 0
        self.peak_hbm_pages = 0
        self.demotions = 0
        self.promotions = 0
        #: admission cap on live sequences (the engine sets it to
        #: ``hbm_pages // decode_working_set_estimate``): concurrent decode
        #: working sets must not shield the whole HBM budget, or miss
        #: promotion starves and everything stalls.  ``None`` = no cap.
        self.max_live_seqs: Optional[int] = None

    def set_callbacks(self, on_demote, on_promote, on_drop_host):
        self._on_demote = on_demote
        self._on_promote = on_promote
        self._on_drop_host = on_drop_host

    # -- tier queries --------------------------------------------------------

    def tier_of(self, page: int) -> str:
        return self._tier[page]

    def host_resident_logical(self, seq_id: int) -> Dict[int, int]:
        """``{logical_page: physical_page}`` for this sequence's pages whose
        bytes are currently in the host tier (device rows poisoned)."""
        return {
            li: p
            for li, p in enumerate(self._tables[seq_id].physical)
            if self._tier[p] == HOST
        }

    def owners_of(self, page: int) -> Owners:
        return sorted(self._owners.get(page, {}).items())

    def is_protected(self, page: int) -> bool:
        return page in self._protected or page in self._auto_protected

    # -- protection / LRU ----------------------------------------------------

    def tick(self):
        self._clock += 1

    def set_protected(self, pages: Iterable[int]):
        """Replace the demotion shield; auto-protection of fresh pages is
        absorbed (the caller's set is now authoritative)."""
        self._protected = set(pages)
        self._auto_protected.clear()

    def touch(self, pages: Iterable[int]):
        """LRU stamp: these physical pages were selected this step."""
        for p in pages:
            self._last_used[p] = self._clock

    # -- migration primitives ------------------------------------------------

    def _demote(self, page: int):
        assert self._tier[page] == HBM, (page, self._tier[page])
        owners = self.owners_of(page)
        assert owners, f"demoting ownerless HBM page {page}"
        if self._on_demote is not None:
            self._on_demote(page, owners)
        self._tier[page] = HOST
        self.hbm_used -= 1
        self.host_used += 1
        self.demotions += 1

    def _promote(self, page: int):
        from_tier = self._tier[page]
        assert from_tier in (HOST, SNAPSHOT), (page, from_tier)
        if self._on_promote is not None:
            self._on_promote(page, self.owners_of(page), from_tier)
        self._tier[page] = HBM
        if from_tier == HOST:
            self.host_used -= 1
        self._count_hbm(1)
        self.promotions += 1
        self._last_used[page] = self._clock
        self._auto_protected.add(page)

    def _count_hbm(self, n: int):
        self.hbm_used += n
        if self.hbm_used > self.peak_hbm_pages:
            self.peak_hbm_pages = self.hbm_used

    def _tier_exhausted(self, msg: str) -> PoolExhausted:
        """Tier-capacity exhaustion (vs free-list shortage).  The flag
        tells the scheduler that prefix-cache eviction cannot help — an
        unpinned page neither frees HBM room nor host room while live
        owners remain — so it must preempt instead of retrying."""
        exc = PoolExhausted(msg)
        exc.tier_bound = True
        return exc

    def _ensure_hbm_room(self, need: int, reason: str):
        while self.hbm_used + need > self.hbm_pages:
            if self.host_used >= self.host_pages:
                raise self._tier_exhausted(
                    f"{reason}: host tier full "
                    f"({self.host_used}/{self.host_pages} pages)"
                )
            victim, stamp = None, None
            for p, own in self._owners.items():
                if (
                    self._tier[p] == HBM
                    and own
                    and not self.is_protected(p)
                ):
                    s = self._last_used.get(p, -1)
                    if stamp is None or s < stamp:
                        victim, stamp = p, s
            if victim is None:
                raise self._tier_exhausted(
                    f"{reason}: HBM budget exhausted "
                    f"({self.hbm_used}/{self.hbm_pages} pages resident, "
                    f"need {need}, all resident pages protected or pinned)"
                )
            self._demote(victim)

    def promote_for_miss(self, page: int):
        """Bring a demoted page a selection needs back to HBM, demoting
        colder pages if necessary.  Raises :class:`PoolExhausted` when the
        shield covers the whole budget (caller retries next tick)."""
        if self._tier[page] != HOST:
            return
        self._ensure_hbm_room(1, "miss promote")
        self._promote(page)

    def prefetch_promote(self, page: int) -> bool:
        """Speculative promotion: only uses *free* HBM headroom — a
        prediction is never worth demoting someone else's resident page."""
        if self._tier[page] != HOST or self.hbm_used >= self.hbm_pages:
            return False
        self._promote(page)
        return True

    # -- allocation overrides ------------------------------------------------

    def _take(self, need: int, reason: str) -> List[int]:
        if need > len(self._free):
            raise PoolExhausted(
                f"{reason} needs {need} pages, only {len(self._free)} free"
            )
        self._ensure_hbm_room(need, reason)
        pages = super()._take(need, reason)
        for p in pages:
            self._tier[p] = HBM
            self._last_used[p] = self._clock
            self._auto_protected.add(p)
        self._count_hbm(need)
        return pages

    def fork(
        self, seq_id: int, shared_pages: Sequence[int], n_tokens: int
    ) -> PageTable:
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        if (
            self.max_live_seqs is not None
            and len(self._tables) >= self.max_live_seqs
        ):
            raise self._tier_exhausted(
                f"admission: {len(self._tables)} live sequences already "
                f"fill the HBM working-set capacity ({self.max_live_seqs})"
            )
        shared = list(shared_pages)
        if len(shared) * self.page_size > n_tokens:
            raise ValueError(
                f"{len(shared)} shared pages cover more than {n_tokens} tokens"
            )
        need_fresh = self.pages_for(n_tokens) - len(shared)
        if need_fresh > len(self._free):
            raise PoolExhausted(
                f"fork needs {need_fresh} pages, "
                f"only {len(self._free)} free"
            )
        to_promote = [p for p in shared if self._tier[p] != HBM]
        # one room reservation for promotions + fresh pages, so the nested
        # ``_take`` never double-demotes.
        self._ensure_hbm_room(need_fresh + len(to_promote), "fork")
        for p in to_promote:
            self._promote(p)
        for p in shared:
            self._auto_protected.add(p)
        table = super().fork(seq_id, shared, n_tokens)
        for li, p in enumerate(table.physical):
            self._owners.setdefault(p, {})[seq_id] = li
        return table

    def extend(self, seq_id: int, n_new_tokens: int) -> PageTable:
        before = self._tables[seq_id].n_pages
        table = super().extend(seq_id, n_new_tokens)
        for li in range(before, table.n_pages):
            self._owners.setdefault(table.physical[li], {})[seq_id] = li
        return table

    def ensure_owned(self, seq_id: int, logical_page: int) -> Tuple[int, int]:
        old_phys = self._tables[seq_id].physical[logical_page]
        if self._refcount[old_phys] > 1 and self._tier[old_phys] == HOST:
            # the caller copies device rows old -> new; make them valid.
            self._ensure_hbm_room(1, "copy-on-write promote")
            self._promote(old_phys)
        old, new = super().ensure_owned(seq_id, logical_page)
        if old != new:
            self._owners[old].pop(seq_id, None)
            self._owners.setdefault(new, {})[seq_id] = logical_page
            self._after_release(old)
        return old, new

    def free(self, seq_id: int):
        pages = list(self._tables[seq_id].physical)
        super().free(seq_id)
        for p in pages:
            own = self._owners.get(p)
            if own is not None:
                own.pop(seq_id, None)
            self._after_release(p)

    def cache_unref(self, page: int):
        super().cache_unref(page)
        self._after_release(page)

    def _after_release(self, page: int):
        """Tier bookkeeping after a reference drop on ``page``."""
        tier = self._tier[page]
        if self._refcount[page] == 0:
            if tier == HBM:
                self.hbm_used -= 1
            elif tier == HOST:
                self.host_used -= 1
                if self._on_drop_host is not None:
                    self._on_drop_host(page)
            self._tier[page] = FREE
            self._owners.pop(page, None)
            self._last_used.pop(page, None)
            self._protected.discard(page)
            self._auto_protected.discard(page)
        elif not self._owners.get(page) and self.is_cache_pinned(page):
            # pin-only: no live slot rows anywhere; the radix snapshot is
            # the surviving copy of the bytes.
            if tier == HBM:
                self.hbm_used -= 1
            elif tier == HOST:
                self.host_used -= 1
                if self._on_drop_host is not None:
                    self._on_drop_host(page)
            self._tier[page] = SNAPSHOT

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {
            "hbm_pages": self.hbm_pages,
            "host_pages": self.host_pages,
            "hbm_used": self.hbm_used,
            "host_used": self.host_used,
            "snapshot_pages": sum(t == SNAPSHOT for t in self._tier),
            "peak_hbm_pages": self.peak_hbm_pages,
            "demotions": self.demotions,
            "promotions": self.promotions,
        }

    def assert_consistent(self, known_pins=None) -> List[int]:
        leaks = super().assert_consistent(known_pins=known_pins)
        free_set = set(self._free)
        n_hbm = n_host = 0
        for p in range(self.total_pages):
            tier = self._tier[p]
            own = self._owners.get(p, {})
            assert (tier == FREE) == (p in free_set), (
                f"page {p}: tier {tier} vs free-list membership"
            )
            if tier == FREE:
                assert not own, f"free page {p} has owners {own}"
            elif tier == SNAPSHOT:
                assert not own and self.is_cache_pinned(p), (
                    f"snapshot page {p}: owners={own} "
                    f"pinned={self.is_cache_pinned(p)}"
                )
            else:
                assert own, f"{tier} page {p} has no live owners"
                n_hbm += tier == HBM
                n_host += tier == HOST
            for sid, li in own.items():
                assert self._tables[sid].physical[li] == p, (
                    f"owner map stale: page {p} seq {sid} logical {li}"
                )
        assert n_hbm == self.hbm_used, (n_hbm, self.hbm_used)
        assert n_host == self.host_used, (n_host, self.host_used)
        assert self.hbm_used <= self.hbm_pages, (
            self.hbm_used, self.hbm_pages
        )
        assert self.host_used <= self.host_pages, (
            self.host_used, self.host_pages
        )
        for sid, t in self._tables.items():
            for li, p in enumerate(t.physical):
                assert self._owners[p].get(sid) == li, (
                    f"seq {sid} logical {li} missing from owners of {p}"
                )
        return leaks
