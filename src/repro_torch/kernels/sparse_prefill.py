"""Query-block sparse flash prefill in one launch per layer.

:func:`sparse_prefill` is the wrapper of the hand-written CUDA kernel
``csrc/sparse_prefill.cu`` (the port of ``repro/kernels/sparse_prefill.py``).
On CUDA tensors it launches the kernel or raises; only for tensors on the CPU
does it run :func:`sparse_prefill_plain`, the plain PyTorch version
(:func:`repro_torch.kernels.ref.sparse_prefill_ref` over the dequantized
score rows).

The kernel runs as a few launches (dequant, score, select, attend, and a
combine when a cell's key tiles are split into more than one run); one call
of the wrapper counts one in ``launches``, and ``plain_calls`` counts calls
of the plain version.  :func:`prefill_split_plan` picks the number of runs,
:func:`prefill_tile_keys` / :func:`prefill_runs` give the tiles a run
attends (the kernel computes the same from its selection on the card).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.stacked import LayoutArrays
from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import expect
from repro_torch.kernels.paged_attention import BLOCKS_PER_SM, _sm_count

launches = 0
plain_calls = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 20 + [_I] * 19 + [_F, _P]
#: keys per attention tile and query rows per warpgroup of an attention block
TILE_KEYS = 64
ROW_TILE = 64


#: most key-tile runs a cell's attention is split into by the plan, and the
#: modeled cost of each run (its prologue and its partial state) as a share
#: of a cell's whole attention
MAX_RUNS = 8
RUN_COST = 0.03
#: "about two blocks per SM": the plan's runs give at least this share of
#: ``BLOCKS_PER_SM`` attention blocks per SM where MAX_RUNS allows
FILL = 0.95


def attend_warpgroups(rows: int, head_dim: int) -> int:
    """Warpgroups (64 query rows each) of one attention block: every row
    tile of the cell up to 3, else 2; 1 at head_dim 256 (as
    ``csrc/sparse_prefill.cu``)."""
    nrt = -(-rows // ROW_TILE)
    return 1 if head_dim == 256 else nrt if nrt <= 3 else 2


def attend_blocks(n_cells: int, rows: int, head_dim: int) -> int:
    """Attention blocks of one run over all cells."""
    return n_cells * -(-rows // (ROW_TILE * attend_warpgroups(rows, head_dim)))


def prefill_plan_cost(n_cells: int, rows: int, n_sm: int, n: int,
                      head_dim: int) -> float:
    """Modeled attention time of n runs per cell, in units of one run's: the
    waves of blocks (one 128 * w-thread block of w warpgroups per SM, two
    of one warpgroup below head_dim 256, one at 256, whose block takes
    most of an SM's shared memory) over n, each run adding ``RUN_COST``."""
    per_sm = 2 if attend_warpgroups(rows, head_dim) == 1 and head_dim < 256 else 1
    blocks = attend_blocks(n_cells, rows, head_dim)
    waves = -(-blocks * n // (per_sm * max(1, n_sm)))
    return waves / n * (1 + RUN_COST * n)


def prefill_split_plan(n_cells: int, rows: int, n_sm: int, head_dim: int) -> int:
    """Runs of key tiles per (sequence, kv head, query block) cell: of the
    run counts 1 .. ``MAX_RUNS`` that give about ``BLOCKS_PER_SM``
    attention blocks per SM (``FILL``), the one of least
    :func:`prefill_plan_cost`, the fewest on a tie (all counts when none
    reaches it)."""
    blocks = attend_blocks(n_cells, rows, head_dim)
    runs = range(1, MAX_RUNS + 1)
    ok = [n for n in runs if blocks * n >= FILL * BLOCKS_PER_SM * n_sm] or list(runs)
    return min(ok, key=lambda n: (
        prefill_plan_cost(n_cells, rows, n_sm, n, head_dim), n))


def prefill_tile_keys(blocks, block_size: int, n_valid: int):
    """The key tiles of one cell: its selected blocks (ascending), each of
    ``block_size`` tokens, in order, cut into tiles of ``TILE_KEYS`` ->
    list of tiles, each a list of ``TILE_KEYS`` key positions, -1 for a key
    the kernel zero-fills and masks (past the last selected token, or at or
    past ``n_valid``)."""
    keys = [b * block_size + i for b in blocks for i in range(block_size)]
    keys = [p if p < n_valid else -1 for p in keys]
    n_t = -(-len(keys) // TILE_KEYS)
    keys += [-1] * (n_t * TILE_KEYS - len(keys))
    return [keys[t * TILE_KEYS:(t + 1) * TILE_KEYS] for t in range(n_t)]


def prefill_tile_needs_mask(tile, q_start: int) -> bool:
    """Whether the kernel masks a tile per key: it holds a masked key, or
    its last key reaches the cell's first query position."""
    return tile[-1] < 0 or tile[-1] >= q_start


def prefill_runs(n_tiles: int, n_split: int):
    """The ``[start, stop)`` tile runs of a cell's ``n_split`` attention
    blocks (runs past the last tile are empty)."""
    per = -(-n_tiles // n_split)
    return [(min(n_tiles, s * per), min(n_tiles, s * per + per))
            for s in range(n_split)]


def candidate_rows_bound(la: LayoutArrays, qb0: int, nQB: int, block_q: int,
                         local_pages: int) -> int:
    """Largest number of candidate blocks any head can have in this chunk
    (those ending before the last query block's local window): the grid of
    the dequant and score kernels."""
    lo = (qb0 + nQB - 1) * block_q - local_pages * la.page_size
    if lo <= 0:
        return 0
    lay = la.host
    return max(min(n, lo // b) for n, b in zip(lay.n_blocks, lay.block_sizes))


def reset_counts():
    global launches, plain_calls
    launches = plain_calls = 0


def sparse_prefill(
    q: torch.Tensor,               # [B, n_kv, nQB, g, BQ, D]
    rq: torch.Tensor,              # [B, n_kv, nQB, g, BQ, Dp] f32
    k_pages: torch.Tensor,         # [B, n_kv, n_pages, page, D]
    v_pages: torch.Tensor,
    codes: torch.Tensor,           # [B, rows, Cw] score-segment codes
    scale: torch.Tensor,           # [B, rows, 1] f32 per-row
    zero: torch.Tensor,
    la: LayoutArrays,              # one layer, on q's device
    k_sel: torch.Tensor,           # [n_kv] int32 prefill-scaled top-K
    n_valid: torch.Tensor,         # [B] int32 live tokens (queries and keys)
    qb0: int,                      # absolute index of query block 0
    *,
    bits: int,
    symmetric: bool,
    block_q: int,
    sink_pages: int,
    local_pages: int,
    return_selected: bool = False,
    n_split: Optional[int] = None,
):
    """-> (out like q, n_attended [B, n_kv, nQB] int32), and with
    ``return_selected`` the selected blocks ``[B, n_kv, nQB, max_blocks]``
    bool as a third element.  ``n_split`` forces the number of key-tile
    runs per cell (default :func:`prefill_split_plan`); the plain version
    ignores it.  On fake or meta tensors: the abstract rule (``_build``)."""
    abstract = _build.is_abstract(q, rq, k_pages, v_pages, codes, scale, zero,
                                  k_sel, n_valid)
    if q.device.type == "cpu" and not abstract:
        return sparse_prefill_plain(
            q, rq, k_pages, v_pages, codes, scale, zero, la, k_sel, n_valid,
            qb0, bits=bits, symmetric=symmetric, block_q=block_q,
            sink_pages=sink_pages, local_pages=local_pages,
            return_selected=return_selected,
        )
    global launches
    B, n_kv, nQB, g, BQ, D = q.shape
    _, _, n_pages, ps, _ = k_pages.shape
    Dp = rq.shape[-1]
    rows = codes.shape[1]
    cw = Dp // 2 if bits == 4 else Dp
    dev = q.device
    expect(q, torch.bfloat16, (B, n_kv, nQB, g, BQ, D), dev, "q")
    expect(rq, torch.float32, (B, n_kv, nQB, g, BQ, Dp), dev, "rq")
    expect(k_pages, torch.bfloat16, (B, n_kv, n_pages, ps, D), dev, "k_pages")
    expect(v_pages, torch.bfloat16, (B, n_kv, n_pages, ps, D), dev, "v_pages")
    expect(codes, torch.uint8 if bits else torch.float32, (B, rows, cw), dev,
           "codes")
    expect(scale, torch.float32, (B, rows, 1), dev, "scale")
    expect(zero, torch.float32, (B, rows, 1), dev, "zero")
    expect(k_sel, torch.int32, (n_kv,), dev, "k_sel")
    expect(n_valid, torch.int32, (B,), dev, "n_valid")
    for name in ("row_offsets", "n_blocks", "block_sizes"):
        expect(getattr(la, name), torch.int32, (n_kv,), dev, f"la.{name}")
    if (D not in (64, 128, 256) or g * BQ > 512 or bits not in (0, 4, 8)
            or la.max_block_size > 64 or BQ != block_q):
        raise ValueError(
            f"sparse_prefill kernel takes head_dim 64/128/256, g*BQ <= 512, "
            f"0/4/8-bit codes and blocks of <= 64 tokens (got D={D}, "
            f"g*BQ={g * BQ}, bits={bits}, max block {la.max_block_size})"
        )
    if ps != la.page_size or rows != la.total_rows:
        raise ValueError("sparse_prefill: inconsistent page / row shapes")
    _build.expect_rows(Dp, "sparse_prefill")
    if n_split is None and not abstract:
        n_split = prefill_split_plan(B * n_kv * nQB, g * BQ, _sm_count(dev), D)
    if n_split is not None and n_split < 1:
        raise ValueError(f"sparse_prefill: n_split {n_split} < 1")
    M = la.max_blocks
    if abstract:
        n_att = q.new_empty((B, n_kv, nQB), dtype=torch.int32)
        if return_selected:
            return (q.new_empty(q.shape), n_att,
                    q.new_empty((B, n_kv, nQB, M), dtype=torch.bool))
        return q.new_empty(q.shape), n_att
    jb = candidate_rows_bound(la, int(qb0), nQB, BQ, local_pages)
    out = torch.empty_like(q)
    n_att = torch.empty((B, n_kv, nQB), dtype=torch.int32, device=dev)
    sel = (torch.empty((B, n_kv, nQB, M), dtype=torch.bool, device=dev)
           if return_selected else None)
    f32 = dict(dtype=torch.float32, device=dev)
    rk = torch.empty((B, rows, Dp) if jb else (0,), **f32)
    score = torch.empty((B * n_kv * nQB, M) if jb else (0,), dtype=torch.int32,
                        device=dev)
    slots = torch.empty((B * n_kv * nQB, M), dtype=torch.int32, device=dev)
    n_part = B * n_kv * nQB * n_split * g * BQ if n_split > 1 else 0
    part_ml = torch.empty((n_part, 2), **f32)
    part_acc = torch.empty((n_part, D), **f32)
    lib = _build.load("sparse_prefill")
    fn = _launcher(lib)
    _build.check_smem(lib.sparse_prefill_smem_bytes(g, BQ, D, Dp, M, n_split),
                      "sparse_prefill")
    rc = fn(
        q.data_ptr(), rq.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        la.row_offsets.data_ptr(), la.n_blocks.data_ptr(), k_sel.data_ptr(),
        la.block_sizes.data_ptr(), n_valid.data_ptr(),
        out.data_ptr(), n_att.data_ptr(), None if sel is None else sel.data_ptr(),
        rk.data_ptr(), score.data_ptr(), slots.data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(),
        B, n_kv, nQB, g, BQ, D, Dp, n_pages, ps, rows,
        codes.shape[2] * codes.element_size(), bits, int(symmetric),
        sink_pages, local_pages, M, int(qb0), jb, n_split,
        1.0 / math.sqrt(D), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "sparse_prefill")
    launches += 1
    return (out, n_att, sel) if return_selected else (out, n_att)


def sparse_prefill_plain(
    q, rq, k_pages, v_pages, codes, scale, zero, la, k_sel, n_valid, qb0, *,
    bits, symmetric, block_q, sink_pages, local_pages, return_selected=False,
):
    """Plain PyTorch version of :func:`sparse_prefill` (same outputs)."""
    global plain_calls
    plain_calls += 1
    rank_rows = ref.dequant_score_rows(codes, scale, zero, bits, symmetric)
    res = ref.sparse_prefill_ref(
        q, rq, k_pages, v_pages, rank_rows, la, k_sel, n_valid, int(qb0),
        block_q, sink_pages, local_pages, extras=return_selected,
    )
    return res[:2] + (res[2]["selected"],) if return_selected else res


def _launcher(lib):
    fn = lib.sparse_prefill_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.sparse_prefill_smem_bytes.argtypes = [_I] * 6
        lib.sparse_prefill_smem_bytes.restype = ctypes.c_size_t
    return fn
