"""Query-block sparse flash prefill in one launch per layer.

:func:`sparse_prefill` is the wrapper of the hand-written CUDA kernel
``csrc/sparse_prefill.cu`` (the port of ``repro/kernels/sparse_prefill.py``).
On CUDA tensors it launches the kernel or raises; only for tensors on the CPU
does it run :func:`sparse_prefill_plain`, the plain PyTorch version
(:func:`repro_torch.kernels.ref.sparse_prefill_ref` over the dequantized
score rows).

``launches`` counts kernel launches and ``plain_calls`` calls of the plain
version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.stacked import LayoutArrays
from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import expect

launches = 0
plain_calls = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 15 + [_I] * 17 + [_F, _P]


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
):
    """-> (out like q, n_attended [B, n_kv, nQB] int32), and with
    ``return_selected`` the selected blocks ``[B, n_kv, nQB, max_blocks]``
    bool as a third element."""
    if q.device.type == "cpu":
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
    if (D not in (64, 128) or g * BQ > 256 or bits not in (0, 4, 8)
            or la.max_block_size > 64 or BQ != block_q):
        raise ValueError(
            f"sparse_prefill kernel takes head_dim 64/128, g*BQ <= 256, "
            f"0/4/8-bit codes and blocks of <= 64 tokens (got D={D}, "
            f"g*BQ={g * BQ}, bits={bits}, max block {la.max_block_size})"
        )
    if ps != la.page_size or rows != la.total_rows:
        raise ValueError("sparse_prefill: inconsistent page / row shapes")
    out = torch.empty_like(q)
    n_att = torch.empty((B, n_kv, nQB), dtype=torch.int32, device=dev)
    sel = (torch.empty((B, n_kv, nQB, la.max_blocks), dtype=torch.bool, device=dev)
           if return_selected else None)
    lib = _build.load("sparse_prefill")
    fn = _launcher(lib)
    _build.check_smem(lib.sparse_prefill_smem_bytes(g, BQ, D, Dp, la.max_blocks),
                      "sparse_prefill")
    rc = fn(
        q.data_ptr(), rq.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        la.row_offsets.data_ptr(), la.n_blocks.data_ptr(), k_sel.data_ptr(),
        la.block_sizes.data_ptr(), n_valid.data_ptr(),
        out.data_ptr(), n_att.data_ptr(), None if sel is None else sel.data_ptr(),
        B, n_kv, nQB, g, BQ, D, Dp, n_pages, ps, rows,
        codes.shape[2] * codes.element_size(), bits, int(symmetric),
        sink_pages, local_pages, la.max_blocks, int(qb0),
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
        lib.sparse_prefill_smem_bytes.argtypes = [_I] * 5
        lib.sparse_prefill_smem_bytes.restype = ctypes.c_size_t
    return fn
