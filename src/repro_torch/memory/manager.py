"""Serving-engine glue for tiered KV memory (counterpart of
``repro.memory.manager``).

The :class:`MemoryManager` owns the host spill store and connects the
:class:`~repro_torch.memory.tiered_pool.TieredPagePool`'s migration events
to byte movement over the engine's device cache
(:class:`~repro_torch.memory.page_io.CachePageIO`), and runs the per-tick
protocol:

``begin_tick``
    Apply staged promotions (misses first, predictions into free
    headroom), then rebuild the demotion shield: every page of a
    prefilling sequence (chunked prefill and the store refreshes read
    whole slot rows), each decoding sequence's last working set (selected
    pages + its tail page), and any in-flight stall targets.

``on_step``
    Called per decoding slot after the decode step, with the selection the
    step emitted and the pages that were host-resident when it launched.
    Overlap -> the sampled token is discarded and the sequence *stalls*:
    promotions are staged, nothing advances, and the next tick re-runs the
    step byte-identically.  Otherwise the token commits: LRU stamps,
    prefetch-hit accounting, working-set update, and margin-predicted cold
    pages are staged.

Only the owning sequence stalls: the rest of the batch commits its tokens
the same tick.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from repro_torch.cache.paged_kv import PoolExhausted
from repro_torch.memory.page_io import CachePageIO
from repro_torch.memory.prefetch import PrefetchQueue
from repro_torch.memory.tiered_pool import HOST, TieredPagePool
from repro_torch.resilience import HostIOError


class MemoryManager:
    def __init__(self, engine, pool: TieredPagePool):
        self.engine = engine
        self.pool = pool
        self.metrics = engine.metrics
        self.io = CachePageIO()
        self.queue = PrefetchQueue()
        #: page -> (k, v) host copies of demoted pages.
        self.host_store: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        #: seq_id -> physical working set (never demoted while live).
        self.working: Dict[int, Set[int]] = {}
        #: seq_id -> physical pages its stalled step is waiting on.
        self.stalled: Dict[int, Set[int]] = {}
        #: speculatively promoted pages not yet referenced by a selection.
        self.prefetched: Set[int] = set()
        #: seq_id -> consecutive ticks its stall's miss-promote failed.
        self._starved: Dict[int, int] = {}
        #: optional :class:`~repro_torch.resilience.FaultInjector`, installed
        #: by ``Engine.set_fault_injector``; ``None`` leaves every I/O path
        #: untouched.
        self.fault = None
        pool.set_callbacks(self._on_demote, self._on_promote,
                           self._on_drop_host)

    def _io_fault(self, op: str, owners):
        """Fault-injection gate for host-tier page I/O.  Raises
        :class:`~repro_torch.resilience.HostIOError` before any migration
        state mutates: the page's bytes stay where they were, so an
        injected I/O failure can never lose data, only delay it.  Nothing
        else is caught here (a real CUDA error propagates)."""
        if self.fault is None:
            return
        sid = owners[0][0] if owners else None
        try:
            self.fault.check_raise(
                "host_io", tick=self.metrics.ticks, seq_id=sid, detail=op
            )
        except HostIOError:
            self.metrics.on_host_io_error(op)
            raise

    # -- pool migration callbacks (byte movement) ----------------------------

    def _layers(self):
        return self.engine.cache["layers"]

    def _slot(self, seq_id: int) -> int:
        return self.engine.scheduler.running[seq_id].slot

    def _on_demote(self, page: int, owners):
        self._io_fault("gather", owners)
        layers = self._layers()
        sid0, li0 = owners[0]
        # all owners' rows hold identical bytes (prefix sharing is
        # page-aligned at the same logical index); save one copy, poison all.
        self.host_store[page] = self.io.gather(layers, self._slot(sid0), li0)
        for sid, li in owners:
            self.io.poison(layers, self._slot(sid), li)
        self.metrics.on_migration(self.io.page_nbytes(layers), demote=True)
        self.prefetched.discard(page)  # demoted before use: wasted prefetch

    def _on_promote(self, page: int, owners, from_tier: str):
        if from_tier != HOST:
            # SNAPSHOT: no live rows were poisoned; the forking sequence's
            # bytes arrive through the engine's prefix-KV install.
            return
        # the injection gate runs before the host_store pop: a fault raised
        # after it would drop the page's only copy.
        self._io_fault("restore", owners)
        kb, vb = self.host_store.pop(page)
        layers = self._layers()
        for sid, li in owners:
            self.io.restore(layers, self._slot(sid), li, kb, vb)
        self.metrics.on_migration(self.io.page_nbytes(layers), demote=False)

    def _on_drop_host(self, page: int):
        self.host_store.pop(page, None)

    # -- per-tick protocol ---------------------------------------------------

    def begin_tick(self):
        self.pool.tick()
        for page, kind in self.queue.drain():
            if self.pool.tier_of(page) != HOST:
                self.queue.skipped += 1  # freed or promoted meanwhile
                continue
            if self.fault is not None and self.fault.fires(
                "promote_delay", self.metrics.ticks
            ):
                # injected slow host link: the staged promotion sits out
                # this tick and retries on the next drain.
                self.queue.requeue(page, kind)
                continue
            if kind == PrefetchQueue.MISS:
                try:
                    self.pool.promote_for_miss(page)
                    self.queue.applied += 1
                except PoolExhausted:
                    # the shield covers the whole budget (or the host link
                    # failed: HostIOError subclasses PoolExhausted); retry
                    # next tick once other sequences commit or retire.
                    self.queue.requeue(page, kind)
            else:
                try:
                    ok = self.pool.prefetch_promote(page)
                except PoolExhausted:     # injected host-I/O failure
                    self.queue.requeue(page, kind)
                    continue
                if ok:
                    self.prefetched.add(page)
                    self.metrics.on_prefetch_staged()
                    self.queue.applied += 1
                else:
                    self.queue.skipped += 1
        # starvation accounting: a stalled sequence whose missing pages are
        # still host-resident after the drain made no progress this tick.
        self._starved = {
            sid: self._starved.get(sid, 0) + 1
            for sid, missing in self.stalled.items()
            if any(self.pool.tier_of(p) == HOST for p in missing)
        }
        self._refresh_protection()

    def starved_seqs(self, threshold: int = 2) -> List[int]:
        """Stalled sequences whose miss-promotes have failed ``threshold``
        consecutive ticks: candidates for forced preemption (their combined
        working-set shields can cover the whole HBM budget, leaving no
        demotion victim for anyone)."""
        return [sid for sid, n in self._starved.items() if n >= threshold]

    def _refresh_protection(self):
        from repro_torch.serving.scheduler import PREFILL

        prot: Set[int] = set()
        for sid, seq in self.engine.scheduler.running.items():
            phys = self.pool.table(sid).physical
            if seq.state == PREFILL:
                prot.update(phys)
            else:
                w = self.working.get(sid)
                prot.update(phys if w is None else w)
                if phys:
                    prot.add(phys[-1])  # append / tail-store refresh target
            prot.update(self.stalled.get(sid, ()))
        self.pool.set_protected(prot)

    def on_step(
        self,
        seq,
        sel_logical: np.ndarray,
        pre_logical: np.ndarray,
        host_before: Dict[int, int],
    ) -> bool:
        """Handle one decoding slot's emitted selection.  -> True when the
        sampled token may commit; False when the sequence stalls."""
        sid = seq.seq_id
        phys = self.pool.table(sid).physical
        sel = [int(l) for l in sel_logical if l < len(phys)]
        sel_phys = {phys[l] for l in sel}
        missing = {host_before[l] for l in sel if l in host_before}
        if missing:
            if sid not in self.stalled:
                self.metrics.on_stall_begin(sid)
                self.metrics.on_prefetch_miss(len(missing))
            self.stalled[sid] = missing
            for p in missing:
                self.queue.submit(p, PrefetchQueue.MISS)
            # the new selection is the authoritative working set: resident
            # pages it dropped become demotable, making room for the
            # promotions.
            self.working[sid] = sel_phys | missing | {phys[-1]}
            return False
        if sid in self.stalled:
            del self.stalled[sid]
            self.metrics.on_stall_end(sid)
        hits = sel_phys & self.prefetched
        if hits:
            self.metrics.on_prefetch_hit(len(hits))
        self.prefetched -= sel_phys
        self.pool.touch(sel_phys)
        self.working[sid] = sel_phys | {phys[-1]}
        for l in pre_logical:
            li = int(l)
            if li < len(phys) and phys[li] not in sel_phys and (
                self.pool.tier_of(phys[li]) == HOST
            ):
                self.queue.submit(phys[li], PrefetchQueue.PREDICT)
        return True

    def forget(self, seq_id: int):
        """Sequence left the running set (retired, preempted, restored or
        failed)."""
        self.working.pop(seq_id, None)
        self._starved.pop(seq_id, None)
        if self.stalled.pop(seq_id, None) is not None:
            self.metrics.on_stall_end(seq_id)

    def end_tick(self):
        self.metrics.set_residency(self.pool.hbm_used, self.pool.host_used)
