"""Paged decode attention over a dense selected-page table.

:func:`paged_attention` is the wrapper of the hand-written CUDA kernel
``csrc/paged_attention.cu`` (the port of ``repro/kernels/paged_attention.py``).
On CUDA tensors it launches the kernel or raises; only for tensors on the CPU
does it run :func:`paged_attention_plain`, the plain PyTorch version
(:func:`repro_torch.kernels.ref.paged_attention_ref`).

``launches`` counts kernel launches and ``plain_calls`` calls of the plain
version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import expect

launches = 0
plain_calls = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 7 + [_F, _P]


def reset_counts():
    global launches, plain_calls
    launches = plain_calls = 0


def paged_attention(
    q: torch.Tensor,               # [B, n_q, D]
    k_pages: torch.Tensor,         # [B, n_kv, n_pages, page, D]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,      # [B, n_kv, P_sel] int32
    page_valid: torch.Tensor,      # [B, n_kv, P_sel] bool
    seq_len: torch.Tensor,         # [B] int32 live tokens
    page_size: int,
) -> torch.Tensor:
    """-> ``[B, n_q, D]`` in q's dtype: softmax over the tokens of the valid
    pages at positions ``< seq_len``."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     page_valid, seq_len, page_size)
    global launches
    B, n_q, D = q.shape
    _, n_kv, n_pages, ps, _ = k_pages.shape
    P = page_table.shape[-1]
    g = n_q // n_kv
    dev = q.device
    expect(q, torch.bfloat16, (B, n_q, D), dev, "q")
    expect(k_pages, torch.bfloat16, (B, n_kv, n_pages, ps, D), dev, "k_pages")
    expect(v_pages, torch.bfloat16, (B, n_kv, n_pages, ps, D), dev, "v_pages")
    expect(page_table, torch.int32, (B, n_kv, P), dev, "page_table")
    expect(page_valid, torch.bool, (B, n_kv, P), dev, "page_valid")
    expect(seq_len, torch.int32, (B,), dev, "seq_len")
    if D not in (64, 128) or not 1 <= g <= 8 or n_q % n_kv:
        raise ValueError(
            f"paged_attention kernel takes head_dim 64/128 and a GQA group "
            f"<= 8 (got D={D}, n_q={n_q}, n_kv={n_kv})"
        )
    if ps != page_size:
        raise ValueError(f"paged_attention: pages of {ps} tokens, page_size {page_size}")
    out = torch.empty_like(q)
    fn = _launcher(_build.load("paged_attention"))
    rc = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), page_valid.data_ptr(), seq_len.data_ptr(),
        out.data_ptr(), B, n_kv, g, D, n_pages, ps, P, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "paged_attention")
    launches += 1
    return out


def paged_attention_plain(q, k_pages, v_pages, page_table, page_valid,
                          seq_len, page_size):
    """Plain PyTorch version of :func:`paged_attention` (same outputs)."""
    global plain_calls
    plain_calls += 1
    return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                   page_valid, seq_len, page_size)


def _launcher(lib):
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn
