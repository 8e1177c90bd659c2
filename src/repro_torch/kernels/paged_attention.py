"""Paged decode attention over a dense selected-page table.

:func:`paged_attention` is the wrapper of the hand-written CUDA kernel
``csrc/paged_attention.cu`` (the port of ``repro/kernels/paged_attention.py``).
On CUDA tensors it launches the kernel or raises; only for tensors on the CPU
does it run :func:`paged_attention_plain`, the plain PyTorch version
(:func:`repro_torch.kernels.ref.paged_attention_ref`).

The kernel splits each (sequence, kv head) cell's slot list into
``n_split`` contiguous runs, one thread block each, and combines the runs'
softmax states; :func:`split_plan` picks ``n_split`` from the shapes and
the card's SM count, :func:`split_ranges` gives the runs.  ``launches``
counts calls that launched the kernel (one per call, the combine pass
included) and ``plain_calls`` calls of the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import expect

launches = 0
plain_calls = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 9 + [_I] * 8 + [_F, _P]
#: thread blocks per SM the split plan aims for
BLOCKS_PER_SM = 2


def split_plan(B: int, n_kv: int, p_sel: int, n_sm: int) -> int:
    """Number of slot runs per (sequence, kv head) cell: about
    ``BLOCKS_PER_SM`` blocks per SM over the ``B * n_kv`` cells, at least
    one slot per run, 1 when the cells alone fill the SMs."""
    p = max(1, p_sel)
    n = min(p, max(1, BLOCKS_PER_SM * n_sm // max(1, B * n_kv)))
    per = -(-p // n)
    return -(-p // per)


def split_ranges(p_sel: int, n_split: int):
    """The ``[start, stop)`` slot runs of the kernel's splits (the last
    runs may be empty when ``n_split`` is forced)."""
    per = -(-p_sel // n_split)
    return [(min(p_sel, s * per), min(p_sel, (s + 1) * per)) for s in range(n_split)]


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
    n_split: Optional[int] = None,
) -> torch.Tensor:
    """-> ``[B, n_q, D]`` in q's dtype: softmax over the tokens of the valid
    pages at positions ``< seq_len``.  ``n_split`` forces the kernel's
    number of slot runs (default :func:`split_plan`); the plain version
    ignores it.  On fake or meta tensors: the abstract rule (``_build``)."""
    abstract = _build.is_abstract(q, k_pages, v_pages, page_table, page_valid,
                                  seq_len)
    if q.device.type == "cpu" and not abstract:
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
    if D not in (64, 128, 256) or not 1 <= g <= 8 or n_q % n_kv:
        raise ValueError(
            f"paged_attention kernel takes head_dim 64/128/256 and a GQA group "
            f"<= 8 (got D={D}, n_q={n_q}, n_kv={n_kv})"
        )
    if ps != page_size:
        raise ValueError(f"paged_attention: pages of {ps} tokens, page_size {page_size}")
    if n_split is None and not abstract:
        n_split = split_plan(B, n_kv, P, _sm_count(dev))
    if n_split is not None and not 1 <= n_split <= max(1, P):
        raise ValueError(f"paged_attention: n_split {n_split} not in [1, {max(1, P)}]")
    if abstract:
        return q.new_empty(q.shape)
    out = torch.empty_like(q)
    rows = B * n_kv * n_split * g if n_split > 1 else 0
    part_ml = torch.empty((rows, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((rows, D), dtype=torch.float32, device=dev)
    fn = _launcher(_build.load("paged_attention"))
    rc = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), page_valid.data_ptr(), seq_len.data_ptr(),
        out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(), B, n_kv, g,
        D, n_pages, ps, P, n_split, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "paged_attention")
    launches += 1
    return out


def paged_attention_plain(q, k_pages, v_pages, page_table, page_valid,
                          seq_len, page_size):
    """Plain PyTorch version of :func:`paged_attention` (same outputs; a
    head with no live token gets the mean V row of its table, as JAX's TPU
    kernel computes it)."""
    global plain_calls
    plain_calls += 1
    return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                   page_valid, seq_len, page_size)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launcher(lib):
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn
