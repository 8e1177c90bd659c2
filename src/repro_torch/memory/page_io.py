"""Device <-> host byte movement for one KV page of the engine's cache
(counterpart of ``repro.memory.page_io``, rewritten for the port's cache).

The engine's device KV cache is slot-contiguous: one ``{"k", "v"}`` per
layer, each ``[batch_slot, n_kv, n_pages, page, head_dim]``.  Physical pool
pages are a host-side accounting concept, so tiering is made physically
honest here: demoting a page copies one owner's slot rows, across every
layer, out to host memory and overwrites every owner's rows with a poison
sentinel; promoting copies them back.  A selection that touches a demoted
page therefore cannot silently read stale bytes: it reads poison, the
owning sequence's step is discarded and re-run after the promotion (the KV
append and the tail-store refresh rewrite the same rows, so the re-run is
byte-identical).

The sentinel is finite (not NaN), so the garbage stays confined to the
stalled sequence's own batch row through the softmax; parity tests against
a flat pool catch any unpoisoned read either way.

``poison`` and ``restore`` write in place on the engine's tensors and
``gather`` only reads them, so a captured decode step keeps replaying over
the addresses it was captured with.  Every copy is synchronous: ``gather``
returns once the bytes are in the host buffer (pinned when the cache is on
the card), ``restore`` once they are back on the device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

#: finite poison: large enough that a read corrupts the output
#: unmistakably, small enough to stay finite through the QK dot (9984 in
#: bf16, as JAX's ``.set`` rounds it).
POISON = 1.0e4

Layers = List[Dict[str, torch.Tensor]]


class CachePageIO:
    """Gather / poison / restore of one (slot, logical page) over a list of
    per-layer cache entries."""

    @staticmethod
    def page_nbytes(layers: Layers) -> int:
        """Bytes moved per page migration (K + V rows across all layers)."""
        k = layers[0]["k"]
        _, n_kv, _, ps, hd = k.shape
        return 2 * len(layers) * n_kv * ps * hd * k.element_size()

    @staticmethod
    def gather(layers: Layers, slot: int, page: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> host copies ``(k, v)``, each ``[n_layers, n_kv, page,
        head_dim]``, of one slot's page."""
        out = []
        for name in ("k", "v"):
            rows = torch.stack([e[name][slot, :, page] for e in layers])
            if rows.is_cuda:
                host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                host.copy_(rows)
                rows = host
            out.append(rows)
        return out[0], out[1]

    @staticmethod
    def poison(layers: Layers, slot: int, page: int):
        for e in layers:
            e["k"][slot, :, page].fill_(POISON)
            e["v"][slot, :, page].fill_(POISON)

    @staticmethod
    def restore(layers: Layers, slot: int, page: int, kb: torch.Tensor,
                vb: torch.Tensor):
        """Copy ``gather``'s rows back into one slot's page."""
        dev = layers[0]["k"].device
        kd, vd = kb.to(dev), vb.to(dev)
        for l, e in enumerate(layers):
            e["k"][slot, :, page].copy_(kd[l])
            e["v"][slot, :, page].copy_(vd[l])
