"""Store/layout-level entry points of the kernels (counterpart of
``repro.kernels.ops``): the staged decode's ``centroid_scores`` (with the
plain ``flat_to_padded``) and ``paged_attention``, the ``fused_decode`` and
``sparse_prefill`` wrappers with the shared sparse-prefill preamble,
``topk_threshold`` (K_h from the layout) and the dense
``flash_attention`` (queries at an offset over a prefix of the keys); all but ``topk_threshold`` have a ``*_reference`` twin
that runs the kernel modules' plain versions (the ``"reference"`` backend,
and the oracle the kernels are held against).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.selection import NEG_INF
from repro_torch.core.sparse_attention import as_paged
from repro_torch.core.stacked import LayoutArrays
from repro_torch.kernels import centroid_score as cs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sparse_prefill as sp
from repro_torch.kernels import topk_threshold as tk


def centroid_scores(
    rq: torch.Tensor,              # [B, n_q, Dp] rank queries
    store,                         # backends.CentroidStore (duck-typed)
    la: LayoutArrays,              # one layer
    n_kv: int,
) -> torch.Tensor:
    """Estimation stage of the staged decode, one kernel launch -> block
    scores ``[B, n_kv, max_blocks]`` (``NEG_INF`` pads)."""
    rq = rq.to(torch.float32).contiguous()
    if store.bits == 0:
        flat = cs.centroid_scores_f32(rq, store.codes, n_kv, la.tile_head,
                                      la.tile_rows)
    else:
        flat = cs.centroid_scores_quantized(
            rq, store.codes, store.scale, store.zero, la.tile_head,
            la.tile_rows, bits=store.bits, symmetric=store.symmetric,
        )
    return flat_to_padded(flat, la)


def centroid_scores_reference(rq, store, la, n_kv):
    """:func:`centroid_scores` through the plain version."""
    flat = cs.centroid_scores_plain(
        rq.to(torch.float32), store.codes, store.scale, store.zero,
        la.tile_head, la.tile_rows, bits=store.bits,
        symmetric=store.symmetric, n_kv=n_kv,
    )
    return flat_to_padded(flat, la)


def flat_to_padded(flat: torch.Tensor, la: LayoutArrays) -> torch.Tensor:
    """Flat scores ``[B, total_rows]`` -> ``[B, n_heads, max_blocks]``, each
    head's rows gathered by ``scatter_rows``, pads set to ``NEG_INF``."""
    picked = flat[:, la.scatter_rows.long()]
    return torch.where(la.pad_mask[None], picked, NEG_INF)


def topk_threshold(scores: torch.Tensor, la: LayoutArrays
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded block scores ``[B, H, M]`` -> (the K_h-th largest score
    ``[B, H]``, the count strictly above it ``[B, H]``), with
    ``K_h = min(T / B_h, context / B_h)`` from the layout."""
    return tk.topk_threshold(scores.contiguous(), la.top_k)


def paged_attention(
    q: torch.Tensor,               # [B, n_q, D]
    k: torch.Tensor,               # paged [B, n_kv, nP, page, D] or dense 4-D
    v: torch.Tensor,
    page_table: torch.Tensor,      # [B, n_kv, P_sel]
    page_valid: torch.Tensor,      # [B, n_kv, P_sel] bool
    page_size: int,
    seq_len: torch.Tensor,         # [B] live tokens
    n_split: Optional[int] = None,
) -> torch.Tensor:
    """Attention stage of the staged decode, one kernel launch ->
    ``[B, n_q, D]`` over the selected pages only (``n_split``: see
    :func:`repro_torch.kernels.paged_attention.paged_attention`)."""
    return _paged_attention(functools.partial(pa.paged_attention, n_split=n_split),
                            q, k, v, page_table, page_valid, page_size, seq_len)


def paged_attention_reference(q, k, v, page_table, page_valid, page_size,
                              seq_len):
    """:func:`paged_attention` through the plain version."""
    return _paged_attention(pa.paged_attention_plain, q, k, v, page_table,
                            page_valid, page_size, seq_len)


def _paged_attention(fn, q, k, v, page_table, page_valid, page_size, seq_len):
    kp, vp = as_paged(k, page_size), as_paged(v, page_size)
    return fn(
        q.contiguous(), kp, vp, page_table.to(torch.int32).contiguous(),
        page_valid.to(torch.bool).contiguous(),
        seq_len.to(torch.int32).reshape(q.shape[0]).contiguous(), page_size,
    )


def fused_decode(
    q: torch.Tensor,               # [B, n_q, D]
    rq: torch.Tensor,              # [B, n_q, Dp] rank queries
    k: torch.Tensor,               # paged [B, n_kv, nP, page, D] or dense 4-D
    v: torch.Tensor,
    store,                         # backends.CentroidStore (duck-typed)
    la: LayoutArrays,
    sink_pages: int,
    local_pages: int,
    seq_len: torch.Tensor,         # [B] live tokens
    n_split: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-launch AB-Sparse decode -> (out [B, n_q, D],
    page_table [B, H, P_sel], page_valid [B, H, P_sel]) (``n_split``: see
    :func:`repro_torch.kernels.fused_decode.fused_decode`)."""
    return _fused_decode(functools.partial(fd.fused_decode, n_split=n_split),
                         q, rq, k, v, store, la, sink_pages, local_pages, seq_len)


def fused_decode_reference(q, rq, k, v, store, la, sink_pages, local_pages,
                           seq_len):
    """:func:`fused_decode` through the plain version."""
    return _fused_decode(fd.fused_decode_plain, q, rq, k, v, store, la,
                         sink_pages, local_pages, seq_len)


def _fused_decode(fn, q, rq, k, v, store, la, sink_pages, local_pages, seq_len):
    kp, vp = as_paged(k, la.page_size), as_paged(v, la.page_size)
    B, Dp = q.shape[0], rq.shape[-1]
    if store.bits == 0:
        scale = torch.ones((B, la.n_heads, Dp), dtype=torch.float32, device=q.device)
        zero = torch.zeros_like(scale)
    else:
        scale, zero = store.scale, store.zero
    return fn(
        q, rq.to(torch.float32).contiguous(), kp, vp, store.codes, scale, zero,
        la, seq_len.to(torch.int32).reshape(B).contiguous(),
        bits=store.bits, symmetric=store.symmetric,
        sink_pages=sink_pages, local_pages=local_pages,
    )


def _prefill_query_blocks(q, rq, la, block_q, topk_scale, n_valid, chunk_offset):
    """Shared preamble of the sparse-prefill kernel and its plain version:
    query-block padding/reshape, the prefill-scaled per-head K, the live
    length per sequence and the chunk's query-block base index."""
    B, Hq, Sq, _ = q.shape
    n_kv = la.n_heads
    g = Hq // n_kv
    nQB = -(-Sq // block_q)
    pad = nQB * block_q - Sq
    if n_valid is None:
        n_valid = chunk_offset + Sq
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32, device=q.device)
    n_valid = n_valid.reshape(-1).expand(B).contiguous()
    qb0 = int(chunk_offset) // block_q

    def to_blocks(x):
        if pad:                                 # F.pad copies even when pad is 0
            x = F.pad(x, (0, 0, 0, pad))
        x = x.reshape(B, n_kv, g, nQB, block_q, x.shape[-1])
        return x.movedim(3, 2).contiguous()     # [B, n_kv, nQB, g, BQ, .]

    k_sel = torch.ceil(la.top_k.to(torch.float32) * topk_scale).to(torch.int32)
    k_sel = torch.minimum(torch.clamp_min(k_sel, 1), la.n_blocks).contiguous()
    return to_blocks(q), to_blocks(rq.to(torch.float32)), k_sel, n_valid, qb0


def _from_blocks(out6: torch.Tensor, Sq: int) -> torch.Tensor:
    B, n_kv, nQB, g, bq, D = out6.shape
    out = out6.movedim(2, 3).reshape(B, n_kv * g, nQB * bq, D)
    return out[:, :, :Sq]


def sparse_prefill(
    q: torch.Tensor,               # [B, Hq, Sq, D]
    rq: torch.Tensor,              # [B, Hq, Sq, Dp] per-token rank queries
    k: torch.Tensor,               # paged [B, n_kv, nP, page, D] or dense 4-D
    v: torch.Tensor,
    score_store,                   # per-row score segment (codes/scale/zero)
    la: LayoutArrays,
    sink_pages: int = 1,
    local_pages: int = 4,
    block_q: int = 64,
    topk_scale: float = 1.0,
    n_valid: Optional[torch.Tensor] = None,
    chunk_offset: int = 0,         # absolute pos of q[..., 0, :]; block_q-aligned
    return_selected: bool = False,
    n_split: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Query-block sparse prefill in one kernel call -> (out [B, Hq, Sq, D],
    n_attended [B, n_kv, nQB]), plus the selected blocks
    ``[B, n_kv, nQB, max_blocks]`` bool with ``return_selected``.
    ``n_valid`` defaults to ``chunk_offset + Sq``, the live length after
    this chunk (``n_split``: see
    :func:`repro_torch.kernels.sparse_prefill.sparse_prefill`)."""
    return _sparse_prefill(functools.partial(sp.sparse_prefill, n_split=n_split),
                           q, rq, k, v, score_store, la,
                           sink_pages, local_pages, block_q, topk_scale,
                           n_valid, chunk_offset, return_selected)


def sparse_prefill_reference(q, rq, k, v, score_store, la, sink_pages=1,
                             local_pages=4, block_q=64, topk_scale=1.0,
                             n_valid=None, chunk_offset=0,
                             return_selected=False):
    """:func:`sparse_prefill` through the plain version."""
    return _sparse_prefill(sp.sparse_prefill_plain, q, rq, k, v, score_store,
                           la, sink_pages, local_pages, block_q, topk_scale,
                           n_valid, chunk_offset, return_selected)


def _sparse_prefill(fn, q, rq, k, v, score_store, la, sink_pages, local_pages,
                    block_q, topk_scale, n_valid, chunk_offset,
                    return_selected):
    kp, vp = as_paged(k, la.page_size), as_paged(v, la.page_size)
    Sq = q.shape[2]
    q6, rq6, k_sel, n_valid, qb0 = _prefill_query_blocks(
        q, rq, la, block_q, topk_scale, n_valid, chunk_offset
    )
    out6, *rest = fn(
        q6, rq6, kp, vp, score_store.codes, score_store.scale,
        score_store.zero, la, k_sel, n_valid, qb0,
        bits=score_store.bits, symmetric=score_store.symmetric,
        block_q=block_q, sink_pages=sink_pages, local_pages=local_pages,
        return_selected=return_selected,
    )
    return (_from_blocks(out6, Sq), *rest)



def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    k_len=None) -> torch.Tensor:
    """Dense GQA attention, one kernel launch: q ``[B, Hq, Sq, D]`` at
    positions ``q_offset + i`` over the keys ``[0, k_len)`` of k/v
    ``[B, Hkv, Sk, D]`` (dense, or a paged cache's dense view), causal
    when asked -> ``[B, Hq, Sq, D]`` (dense prefill, chunked or not)."""
    return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal, q_offset, k_len)


def flash_attention_reference(q, k, v, causal=True, q_offset=0, k_len=None):
    """:func:`flash_attention` through the plain version."""
    return fa.flash_attention_plain(q, k, v, causal, q_offset, k_len)
