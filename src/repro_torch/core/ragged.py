"""Static ragged layout for heterogeneous per-head block sizes (numpy only;
a copy of ``repro.core.ragged`` so the port imports nothing of ``repro``).

Block-size assignments are frozen at calibration time, so every per-head
centroid count, prefix offset and tile->head map is a constant of the
(layer, context_len) pair.  The number of *selected pages* per head is
``K_h * B_h / page_size == T / page_size`` for every head: raggedness is
confined to estimation, the attention stage is uniform.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class RaggedLayout:
    """Frozen per-(layer, context) layout."""

    block_sizes: Tuple[int, ...]   # B_h per kv head
    context_len: int
    page_size: int
    token_budget: int
    tile_rows: int = 128           # centroid rows per segment tile

    def __post_init__(self):
        for b in self.block_sizes:
            assert b % self.page_size == 0, (b, self.page_size)
            assert self.token_budget % b == 0, (
                f"token budget {self.token_budget} must be a multiple of every "
                f"assigned block size (got B={b})"
            )
            assert self.context_len % b == 0, (self.context_len, b)

    @property
    def n_heads(self) -> int:
        return len(self.block_sizes)

    @cached_property
    def n_blocks(self) -> Tuple[int, ...]:
        return tuple(self.context_len // b for b in self.block_sizes)

    @cached_property
    def pages_per_block(self) -> Tuple[int, ...]:
        return tuple(b // self.page_size for b in self.block_sizes)

    @cached_property
    def top_k(self) -> Tuple[int, ...]:
        """K_h = T / B_h."""
        return tuple(
            min(self.token_budget // b, n)
            for b, n in zip(self.block_sizes, self.n_blocks)
        )

    @property
    def n_pages(self) -> int:
        return self.context_len // self.page_size

    @property
    def selected_pages(self) -> int:
        sel = {k * s for k, s in zip(self.top_k, self.pages_per_block)}
        assert len(sel) == 1, f"selected-page count not uniform: {sel}"
        return sel.pop()

    @cached_property
    def padded_n_blocks(self) -> Tuple[int, ...]:
        r = self.tile_rows
        return tuple(((n + r - 1) // r) * r for n in self.n_blocks)

    @cached_property
    def offsets(self) -> Tuple[int, ...]:
        """Prefix-sum offsets into the flattened padded centroid array."""
        off = [0]
        for p in self.padded_n_blocks:
            off.append(off[-1] + p)
        return tuple(off)

    @property
    def total_rows(self) -> int:
        return self.offsets[-1]

    @property
    def n_tiles(self) -> int:
        return self.total_rows // self.tile_rows

    @cached_property
    def tile_head(self) -> np.ndarray:
        """Head id owning each tile of the flattened store."""
        out = np.empty(self.n_tiles, dtype=np.int32)
        t = 0
        for h, p in enumerate(self.padded_n_blocks):
            for _ in range(p // self.tile_rows):
                out[t] = h
                t += 1
        return out

    @property
    def max_blocks(self) -> int:
        return max(self.padded_n_blocks)

    @cached_property
    def scatter_rows(self) -> np.ndarray:
        """[n_heads, max_blocks] flat-row gather indices of the padded 2-D
        score view (pad slots point at row 0 and are masked by pad_mask)."""
        idx = np.zeros((self.n_heads, self.max_blocks), dtype=np.int32)
        for h in range(self.n_heads):
            n = self.n_blocks[h]
            idx[h, :n] = np.arange(self.offsets[h], self.offsets[h] + n)
        return idx

    @cached_property
    def pad_mask(self) -> np.ndarray:
        m = np.zeros((self.n_heads, self.max_blocks), dtype=bool)
        for h in range(self.n_heads):
            m[h, : self.n_blocks[h]] = True
        return m

    @cached_property
    def block_starts(self) -> np.ndarray:
        """[n_heads, max_blocks] token start offset of each block."""
        starts = np.arange(self.max_blocks)[None, :] * np.asarray(
            self.block_sizes, dtype=np.int64
        )[:, None]
        return np.minimum(starts, 2**30).astype(np.int32)

    @cached_property
    def max_top_k(self) -> int:
        return max(self.top_k)

    @cached_property
    def slot_map(self) -> np.ndarray:
        """[n_heads, selected_pages] -> top-k slot producing page j."""
        out = np.zeros((self.n_heads, self.selected_pages), dtype=np.int32)
        for h, s in enumerate(self.pages_per_block):
            out[h] = np.arange(self.selected_pages) // s
        return out

    @cached_property
    def within_map(self) -> np.ndarray:
        """[n_heads, selected_pages] -> page offset within the block."""
        out = np.zeros((self.n_heads, self.selected_pages), dtype=np.int32)
        for h, s in enumerate(self.pages_per_block):
            out[h] = np.arange(self.selected_pages) % s
        return out

    def prefill_max_slots(
        self, block_q: int, sink_pages: int, local_pages: int,
        topk_scale: float,
    ) -> int:
        return prefill_max_slots_arrays(
            self.block_sizes, self.top_k, self.n_blocks, self.page_size,
            block_q, sink_pages, local_pages, topk_scale,
        )


def prefill_max_slots_arrays(
    bsz, top_k, n_blocks, page_size, block_q, sink_pages, local_pages,
    topk_scale,
) -> int:
    """Upper bound on the blocks one (query-block, head) cell of sparse
    prefill attends: scored top-K plus sink and local/diagonal blocks."""
    bsz = np.asarray(bsz)
    n_blocks = np.asarray(n_blocks)
    ks = np.minimum(
        n_blocks,
        np.maximum(
            1,
            np.ceil(
                np.asarray(top_k, np.float32) * np.float32(topk_scale)
            ).astype(np.int64),
        ),
    )
    sink_tok = sink_pages * page_size
    n_sink = -(-sink_tok // bsz) if sink_tok else np.zeros_like(bsz)
    n_local = (local_pages * page_size + block_q) // bsz + 1
    return int(min(np.max(ks + n_sink + n_local), np.max(n_blocks)))


def uniform_layout(
    n_heads: int, block_size: int, context_len: int, page_size: int,
    token_budget: int, tile_rows: int = 128,
) -> RaggedLayout:
    """Every head at one block size (the calibration pass's layout)."""
    return RaggedLayout(
        block_sizes=(block_size,) * n_heads,
        context_len=context_len,
        page_size=page_size,
        token_budget=token_budget,
        tile_rows=tile_rows,
    )


def layout_for(
    block_sizes, context_len: int, page_size: int, token_budget: int,
    tile_rows: int = 128,
) -> RaggedLayout:
    """Layout with the budget rounded down to the lcm of the block sizes."""
    lcm = 1
    for b in set(block_sizes):
        lcm = math.lcm(lcm, b)
    budget = max(lcm, (min(token_budget, context_len) // lcm) * lcm)
    return RaggedLayout(
        block_sizes=tuple(int(b) for b in block_sizes),
        context_len=context_len,
        page_size=page_size,
        token_budget=budget,
        tile_rows=tile_rows,
    )
