"""Fused AB-Sparse decode: score -> exact top-K_h -> attend in one launch.

:func:`fused_decode` is the wrapper of the hand-written CUDA kernel
``csrc/fused_decode.cu`` (the port of ``repro/kernels/fused_decode.py``).
On CUDA tensors it launches the kernel or raises; only for tensors on the CPU
does it run :func:`fused_decode_plain`, the plain PyTorch version of the same
function (dequant -> broadcast-sum scores -> mask/pin -> stable-sort top-K ->
ascending block order -> paged attention).

The call scores every store row with the staged path's scoring kernel,
selects the top-K_h into the page table (one block per (sequence, kv
head)), then attends the
table's slots in ``n_split`` runs per (sequence, kv head) and combines the
runs' softmax states; the default is
:func:`repro_torch.kernels.paged_attention.split_plan`, as for the staged
paged attention.  One call counts one in ``launches``.

``launches`` counts kernel launches and ``plain_calls`` calls of the plain
version, so a run can show which of the two it went through.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.selection import NEG_INF, rank_blocks
from repro_torch.core.sparse_attention import paged_attention_reference
from repro_torch.core.stacked import LayoutArrays
from repro_torch.kernels import _build, ref
from repro_torch.kernels.paged_attention import _sm_count, split_plan
from repro_torch.kernels._build import expect

launches = 0
plain_calls = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 20 + [_I] * 18 + [_F, _P]
_BIG = 1 << 30


def reset_counts():
    global launches, plain_calls
    launches = plain_calls = 0


def fused_decode(
    q: torch.Tensor,               # [B, n_q, D]
    rq: torch.Tensor,              # [B, n_q, Dp] f32 rank queries
    k_pages: torch.Tensor,         # [B, n_kv, n_pages, page, D]
    v_pages: torch.Tensor,
    codes: torch.Tensor,           # [B, rows, Cw] store codes
    scale: torch.Tensor,           # [B, n_kv, Dp] f32
    zero: torch.Tensor,
    la: LayoutArrays,              # one layer, on q's device
    seq_len: torch.Tensor,         # [B] int32 live tokens
    *,
    bits: int,
    symmetric: bool,
    sink_pages: int,
    local_pages: int,
    n_split: Optional[int] = None,
):
    """-> (out [B, n_q, D], page_table [B, n_kv, P_sel] int32,
    page_valid [B, n_kv, P_sel] bool); slots hold the selected blocks in
    ascending block order.  ``n_split`` forces the kernel's number of slot
    runs (default :func:`split_plan`); the plain version ignores it."""
    if q.device.type == "cpu":
        return fused_decode_plain(
            q, rq, k_pages, v_pages, codes, scale, zero, la, seq_len,
            bits=bits, symmetric=symmetric, sink_pages=sink_pages,
            local_pages=local_pages,
        )
    global launches
    B, n_q, D = q.shape
    _, n_kv, n_pages, ps, _ = k_pages.shape
    Dp = rq.shape[-1]
    g = n_q // n_kv
    rows = codes.shape[1]
    cw = Dp // 2 if bits == 4 else Dp
    dev = q.device
    expect(q, torch.bfloat16, (B, n_q, D), dev, "q")
    expect(rq, torch.float32, (B, n_q, Dp), dev, "rq")
    expect(k_pages, torch.bfloat16, (B, n_kv, n_pages, ps, D), dev, "k_pages")
    expect(v_pages, torch.bfloat16, (B, n_kv, n_pages, ps, D), dev, "v_pages")
    expect(codes, torch.uint8 if bits else torch.float32, (B, rows, cw), dev,
            "codes")
    expect(scale, torch.float32, (B, n_kv, Dp), dev, "scale")
    expect(zero, torch.float32, (B, n_kv, Dp), dev, "zero")
    expect(seq_len, torch.int32, (B,), dev, "seq_len")
    for name in ("row_offsets", "n_blocks", "top_k", "block_sizes",
                 "pages_per_block"):
        expect(getattr(la, name), torch.int32, (n_kv,), dev, f"la.{name}")
    expect(la.tile_head, torch.int32, (rows // la.tile_rows,), dev, "la.tile_head")
    if D not in (64, 128) or not 1 <= g <= 8 or bits not in (0, 4, 8):
        raise ValueError(
            f"fused_decode kernel takes head_dim 64/128, GQA group <= 8 and "
            f"0/4/8-bit codes (got D={D}, g={g}, bits={bits})"
        )
    if n_q % n_kv or ps != la.page_size or rows != la.total_rows:
        raise ValueError("fused_decode: inconsistent head / page / row shapes")
    _build.expect_rows(Dp, "fused_decode", codes=codes, scale=scale, zero=zero)
    P = la.selected_pages
    if n_split is None:
        n_split = split_plan(B, n_kv, P, _sm_count(dev))
    if not 1 <= n_split <= P:
        raise ValueError(f"fused_decode: n_split {n_split} not in [1, {P}]")
    out = torch.empty_like(q)
    table = torch.empty((B, n_kv, P), dtype=torch.int32, device=dev)
    valid = torch.empty((B, n_kv, P), dtype=torch.bool, device=dev)
    flat = torch.empty((B, rows), dtype=torch.float32, device=dev)
    rows_p = B * n_kv * n_split * g if n_split > 1 else 0
    part_ml = torch.empty((rows_p, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((rows_p, D), dtype=torch.float32, device=dev)
    lib = _build.load("fused_decode")
    fn = _launcher(lib)
    _build.check_smem(lib.fused_decode_smem_bytes(
        D, g, Dp, la.max_blocks, la.max_top_k), "fused_decode")
    rc = fn(
        q.data_ptr(), rq.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        la.tile_head.data_ptr(), la.row_offsets.data_ptr(), la.n_blocks.data_ptr(),
        la.top_k.data_ptr(), la.block_sizes.data_ptr(),
        la.pages_per_block.data_ptr(), seq_len.data_ptr(),
        out.data_ptr(), table.data_ptr(), valid.data_ptr(), flat.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(),
        B, n_kv, g, D, Dp, n_pages, ps, rows, la.tile_rows,
        codes.shape[2] * codes.element_size(), bits, int(symmetric),
        sink_pages, local_pages, la.max_blocks, la.max_top_k, P, n_split,
        1.0 / math.sqrt(D), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "fused_decode")
    launches += 1
    return out, table, valid


def fused_decode_plain(
    q, rq, k_pages, v_pages, codes, scale, zero, la, seq_len, *,
    bits, symmetric, sink_pages, local_pages,
):
    """Plain PyTorch version of :func:`fused_decode` (same outputs)."""
    global plain_calls
    plain_calls += 1
    B, n_q, D = q.shape
    n_kv = k_pages.shape[1]
    g = n_q // n_kv
    rank_rows = ref.dequant_store_rows(codes, scale, zero, la, bits, symmetric)
    rk = rank_rows[:, la.scatter_rows.long()]                 # [B, H, M, Dp]
    rq4 = rq.to(torch.float32).reshape(B, n_kv, g, -1)
    scores = ref.row_scores(rk, rq4).amax(dim=2)              # [B, H, M]
    vals, idx = rank_blocks(scores, la, seq_len, sink_pages, local_pages)
    kmax = la.max_top_k
    in_k = (
        torch.arange(kmax, device=q.device)[None, :] < la.top_k[:, None]
    ).expand(B, -1, -1)
    order = torch.argsort(torch.where(in_k, idx, _BIG), dim=-1, stable=True)
    blk = torch.gather(idx, 2, order)
    live = torch.gather(in_k, 2, order) & (torch.gather(vals, 2, order) > NEG_INF / 2)
    slot = la.slot_map.long().expand(B, -1, -1)
    table = torch.gather(blk, 2, slot) * la.pages_per_block[None, :, None]
    table = torch.clamp(table + la.within_map[None], 0, la.n_pages - 1)
    valid = torch.gather(live, 2, slot)
    out = paged_attention_reference(
        q, k_pages, v_pages, table, valid, la.page_size, seq_len
    )
    return out, table.to(torch.int32), valid


def _launcher(lib):
    fn = lib.fused_decode_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.fused_decode_smem_bytes.argtypes = [_I] * 5
        lib.fused_decode_smem_bytes.restype = ctypes.c_size_t
    return fn

