"""Layouts as tensors (counterpart of ``repro.core.stacked``).

:class:`LayoutArrays` holds one layer's ragged layout (or a ``[L, ...]``
stack of them) as int32/bool tensors on the model's device, so the kernels
and the plain selection code read per-head descriptors without host
round trips.  Dims that must be uniform across layers (max_blocks,
selected_pages, total_rows, max_top_k, page_size) are padded to the max
over layers and kept as Python ints.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ragged import RaggedLayout

_TENSOR_FIELDS = (
    "scatter_rows", "pad_mask", "block_starts", "block_sizes", "slot_map",
    "within_map", "pages_per_block", "tile_head", "row_offsets", "n_blocks",
    "top_k",
)


@dataclass(frozen=True)
class LayoutArrays:
    scatter_rows: torch.Tensor     # [.., H, max_blocks] int32 flat-row gather idx
    pad_mask: torch.Tensor         # [.., H, max_blocks] bool
    block_starts: torch.Tensor     # [.., H, max_blocks] int32 token offset
    block_sizes: torch.Tensor      # [.., H] int32
    slot_map: torch.Tensor         # [.., H, P_sel] int32
    within_map: torch.Tensor       # [.., H, P_sel] int32
    pages_per_block: torch.Tensor  # [.., H] int32
    tile_head: torch.Tensor        # [.., n_tiles] int32
    row_offsets: torch.Tensor      # [.., H] int32 flat-row offset per head
    n_blocks: torch.Tensor         # [.., H] int32 real block count per head
    top_k: torch.Tensor            # [.., H] int32 K_h per head
    page_size: int
    tile_rows: int
    max_top_k: int
    selected_pages: int
    total_rows: int
    max_blocks: int
    context_len: int
    token_budget: int
    max_block_size: int            # largest B_h over heads (and layers)
    #: the host-side layouts this was built from (one per layer), for
    #: index arithmetic that must not wait on the device.
    host_layouts: Tuple[RaggedLayout, ...] = ()

    @property
    def n_heads(self) -> int:
        return self.block_sizes.shape[-1]

    @property
    def n_pages(self) -> int:
        return self.context_len // self.page_size

    @property
    def host(self) -> RaggedLayout:
        """The host layout of a one-layer view."""
        assert len(self.host_layouts) == 1, "host layout of a layer stack"
        return self.host_layouts[0]

    def layer(self, l: int) -> "LayoutArrays":
        """One layer of a ``[L, ...]`` stack."""
        return dataclasses.replace(
            self, host_layouts=(self.host_layouts[l],),
            **{f: getattr(self, f)[l] for f in _TENSOR_FIELDS},
        )



def _t(x, dtype=torch.int32, device=None) -> torch.Tensor:
    a = np.asarray(x)
    if torch._guards.detect_fake_mode() is not None:
        # under FakeTensorMode (the contract verifier) a descriptor is its
        # shape: no host values ride along, so a step that reads one on the
        # host fails as a host sync, and a device this build lacks is no
        # obstacle (the mode would move a numpy-made host tensor for real)
        return torch.empty(a.shape, dtype=dtype, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def as_arrays(layout: RaggedLayout, device=None) -> LayoutArrays:
    """One layer's layout as tensors on ``device``."""
    return stack_layouts([layout], device).layer(0)


def stack_layouts(layouts: Sequence[RaggedLayout], device=None) -> LayoutArrays:
    """Per-layer layouts -> one LayoutArrays with a leading layer axis.

    Ragged-across-layers dims are padded to the max: extra scatter rows
    point at row 0 with ``pad_mask=False``, extra tiles map to head 0."""
    assert layouts, "need at least one layout"
    for attr in ("page_size", "token_budget", "context_len", "tile_rows",
                 "selected_pages", "n_heads"):
        assert len({getattr(l, attr) for l in layouts}) == 1, attr
    H = layouts[0].n_heads
    max_blocks = max(l.max_blocks for l in layouts)
    total_rows = max(l.total_rows for l in layouts)
    max_top_k = max(l.max_top_k for l in layouts)
    n_tiles = total_rows // layouts[0].tile_rows
    P_sel = layouts[0].selected_pages
    L = len(layouts)

    scat = np.zeros((L, H, max_blocks), np.int32)
    mask = np.zeros((L, H, max_blocks), bool)
    starts = np.full((L, H, max_blocks), 2**30, np.int32)
    tiles = np.zeros((L, n_tiles), np.int32)
    for i, l in enumerate(layouts):
        mb = l.max_blocks
        scat[i, :, :mb] = l.scatter_rows
        mask[i, :, :mb] = l.pad_mask
        starts[i, :, :mb] = l.block_starts
        tiles[i, : l.n_tiles] = l.tile_head

    def per_head(attr):
        return _t([list(getattr(l, attr)) for l in layouts], device=device)

    return LayoutArrays(
        scatter_rows=_t(scat, device=device),
        pad_mask=_t(mask, torch.bool, device),
        block_starts=_t(starts, device=device),
        block_sizes=per_head("block_sizes"),
        slot_map=_t(np.stack([l.slot_map for l in layouts]), device=device),
        within_map=_t(np.stack([l.within_map for l in layouts]), device=device),
        pages_per_block=per_head("pages_per_block"),
        tile_head=_t(tiles, device=device),
        row_offsets=_t([l.offsets[:-1] for l in layouts], device=device),
        n_blocks=per_head("n_blocks"),
        top_k=per_head("top_k"),
        page_size=layouts[0].page_size,
        tile_rows=layouts[0].tile_rows,
        max_top_k=max_top_k,
        selected_pages=P_sel,
        total_rows=total_rows,
        max_blocks=max_blocks,
        context_len=layouts[0].context_len,
        token_budget=layouts[0].token_budget,
        max_block_size=max(max(l.block_sizes) for l in layouts),
        host_layouts=tuple(layouts),
    )
