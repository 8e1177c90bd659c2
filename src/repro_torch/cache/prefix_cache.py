"""Radix-tree prefix index over page-granular token-id chunks (a copy of
``repro.cache.prefix_cache`` without its trace hooks; the port's engine
keeps each node's KV snapshot on the device).

Keys are tuples of ``page_size`` consecutive prompt token ids — AB-Sparse's
fixed 16-token physical page is exactly the sharing unit, so a cached
prefix's pages (and the centroid-store rows derived from them) are reusable
by any request whose prompt starts with the same token chunks.

Each node owns one physical page (a ``cache_ref`` pin in the
:class:`~repro_torch.cache.paged_kv.PagePool`) plus a host-side KV snapshot of
that page's rows, installed into a new request's slot on a hit.  Eviction
is LRU over *evictable leaves*: nodes with no children whose page refcount
is exactly 1 (i.e. held only by the cache — evicting a page a live
sequence still shares would release no memory).
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cache.paged_kv import PagePool


class _Node:
    __slots__ = ("key", "page", "kv", "parent", "children", "last_used")

    def __init__(self, key, page, kv, parent):
        self.key = key
        self.page = page
        self.kv = kv
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class PrefixCache:
    """Longest-page-aligned-prefix index with LRU eviction."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root = _Node(None, -1, None, None)
        self._clock = itertools.count(1)
        self.n_pages = 0
        # counters surfaced in metrics snapshots
        self.hits = 0
        self.misses = 0
        self.evicted_pages = 0

    # -- lookup --------------------------------------------------------------

    def _chunks(self, tokens: np.ndarray):
        ps = self.page_size
        for i in range(len(tokens) // ps):
            yield tuple(int(t) for t in tokens[i * ps : (i + 1) * ps])

    def match(
        self, tokens: np.ndarray, max_tokens: Optional[int] = None
    ) -> Tuple[int, List[int], List[Any]]:
        """Longest cached page-aligned prefix of ``tokens``.

        -> ``(n_matched_tokens, physical_pages, kv_snapshots)``; the caller
        must take its own page references (``PagePool.fork``) before any
        operation that could evict.  ``max_tokens`` caps the match (e.g. to
        ``len(tokens) - 1`` so at least one suffix token is left to produce
        first-token logits)."""
        node = self._root
        pages: List[int] = []
        kvs: List[Any] = []
        tick = next(self._clock)
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        for i, key in enumerate(self._chunks(tokens)):
            if (i + 1) * self.page_size > limit:
                break
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = tick
            pages.append(child.page)
            kvs.append(child.kv)
            node = child
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return len(pages) * self.page_size, pages, kvs

    # -- insertion -----------------------------------------------------------

    def insert(
        self,
        tokens: np.ndarray,
        pages: Sequence[int],
        kv_fn: Callable[[int], Any],
    ) -> int:
        """Register the page-aligned prefix of ``tokens``; ``pages[i]`` is
        the physical page backing chunk ``i``.  Chunks already present are
        only LRU-touched (their original page/KV stays — no double pin);
        new chunks pin their page and snapshot KV via ``kv_fn(i)`` (called
        lazily, only for chunks actually inserted).  -> pages inserted."""
        node = self._root
        tick = next(self._clock)
        inserted = 0
        for i, key in enumerate(self._chunks(tokens)):
            if i >= len(pages):
                break
            child = node.children.get(key)
            if child is None:
                child = _Node(key, pages[i], kv_fn(i), node)
                self.pool.cache_ref(pages[i])
                node.children[key] = child
                self.n_pages += 1
                inserted += 1
            child.last_used = tick
            node = child
        return inserted

    # -- introspection -------------------------------------------------------

    def pages(self):
        """The set of physical pages this cache currently pins — the
        ``known_pins`` argument for ``PagePool.assert_consistent`` leak
        audits."""
        out = set()
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            out.add(n.page)
        return out

    # -- eviction ------------------------------------------------------------

    def _evictable_leaves(self, protect: frozenset) -> List[_Node]:
        out: List[_Node] = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.page not in protect and self.pool.refcount(n.page) == 1:
                out.append(n)
        return out

    def _drop(self, node: _Node):
        del node.parent.children[node.key]
        self.pool.cache_unref(node.page)
        self.n_pages -= 1
        self.evicted_pages += 1

    def evict_for(self, need_free: int, protect: Sequence[int] = ()) -> bool:
        """Evict LRU leaves until ``pool.free_pages >= need_free`` (never a
        page in ``protect`` nor one a live sequence still shares).
        -> True when the target was reached."""
        protect = frozenset(protect)
        while self.pool.free_pages < need_free:
            leaves = self._evictable_leaves(protect)
            if not leaves:
                return False
            victim = min(leaves, key=lambda n: n.last_used)
            # dropping a leaf may expose its parent; loop re-collects.
            self._drop(victim)
        return True

    def clear(self):
        """Release every cached page (pins on pages still shared by live
        sequences are released too; those pages stay allocated)."""
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.cache_unref(n.page)
            self.n_pages -= 1
        self._root.children.clear()
