"""Logical axes of the serving cache (the serving part of
``repro.distributed.params``).

The port's cache holds one entry per layer (``cache["layers"][l]``, batch
on axis 0), where JAX stacks the layers of a cycle on a leading axis; the
axes below are JAX's ``_CACHE_RULES`` with that axis dropped, for each
entry the ``("attn",)`` stack allocates, and ``seq_len``.  Two entries
differ from JAX's rules on purpose:

- ``scale`` / ``zero`` of the decode store split over ``kv_heads``, as
  JAX's kernel partitioning splits them at the ``shard_map`` boundary
  (``head_aligned_params``); JAX's cache rule keeps them whole and
  reshards;
- the flat row axis of ``codes`` and of the prefill score segment
  (``pcodes`` / ``pscale`` / ``pzero``) splits with the heads whose rows
  they are (:func:`~repro_torch.distributed.kernel_partition.shard_layout`);
  JAX keeps it whole (``kv_pages`` / None, both replicated under the
  serving rules).

The training rules (``rules_for``'s train branch, FSDP) are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

#: entry name -> logical axes of a port cache entry
CACHE_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "seq_len": ("batch",),
    # paged KV [B, n_kv, n_pages, page, hd]
    "k": ("batch", "kv_heads", "kv_pages", None, "head_dim"),
    "v": ("batch", "kv_heads", "kv_pages", None, "head_dim"),
    # decode store: codes [B, rows, Cw] (rows grouped by kv head),
    # per-head affine params [B, n_kv, Dp]
    "codes": ("batch", "kv_heads", None),
    "scale": ("batch", "kv_heads", None),
    "zero": ("batch", "kv_heads", None),
    # prefill score segment: per-row codes and affine params [B, rows, .]
    "pcodes": ("batch", "kv_heads", None),
    "pscale": ("batch", "kv_heads", None),
    "pzero": ("batch", "kv_heads", None),
}

#: entries whose ``kv_heads`` axis is the flat store row axis (split by
#: head segment, not by index): where the port departs from JAX's rule
ROW_AXIS_ENTRIES = ("codes", "pcodes", "pscale", "pzero")


#: entries planted on purpose that the table leaves replicated, each with
#: its reason
PLANTED_CACHE_ENTRIES: Dict[str, str] = {
    "la": "each layer's layout descriptors (LayoutArrays), a rank's own "
          "from kernel_partition.shard_layout",
    "max_context": "a Python int, the rows the cache holds",
    "shard": "the rank's Shard, plain data",
    "_telemetry": "decode sparsity counters [n_layers, B, 4], read once a tick",
    "_ptel": "prefill attended-pair counters [n_layers], read once a chunk",
    "_sel_pages": "tiered memory's selected-page mask [B, n_pages]",
    "_pre_pages": "tiered memory's predicted-page mask [B, n_pages]",
}


def cache_entry_covered(name: str, ndim: int) -> bool:
    """True when cache entry ``name`` of ``ndim`` dims is held by
    :data:`CACHE_AXES` at that rank, or planted on purpose
    (:data:`PLANTED_CACHE_ENTRIES`): anything else would fall through
    :func:`logical_axes_for_cache`'s replicate-by-default, which for a new
    KV entry is a memory-scaling bug, not a default (JAX's
    ``cache_leaf_covered``)."""
    if name in PLANTED_CACHE_ENTRIES:
        return True
    axes = CACHE_AXES.get(name)
    return axes is not None and len(axes) == ndim


def logical_axes_for_cache(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes of cache entry ``name`` of ``ndim`` dims (replicated,
    all None, for an entry the table does not hold or of another rank)."""
    axes = CACHE_AXES.get(name)
    if axes is None or len(axes) != ndim:
        return (None,) * ndim
    return axes
