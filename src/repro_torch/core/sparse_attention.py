"""Reference attention primitives (counterpart of
``repro.core.sparse_attention``): the plain attention stage of the sparse
decode and the full-attention decode oracle (the paper's Full Attention
baseline)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def as_paged(kv: torch.Tensor, page_size: int) -> torch.Tensor:
    """Normalize KV to the paged ``[B, n_kv, n_pages, page, D]`` layout."""
    if kv.ndim == 5:
        assert kv.shape[3] == page_size, (kv.shape, page_size)
        return kv
    B, n_kv, S, D = kv.shape
    return kv.reshape(B, n_kv, S // page_size, page_size, D)


def as_dense(kv: torch.Tensor) -> torch.Tensor:
    """Paged ``[B, n_kv, n_pages, page, D]`` -> dense ``[B, n_kv, S, D]`` (a
    view: the bytes are the same)."""
    if kv.ndim == 4:
        return kv
    B, n_kv, n_pages, page, D = kv.shape
    return kv.reshape(B, n_kv, n_pages * page, D)


def gather_pages(kv: torch.Tensor, page_table: torch.Tensor,
                 page_size: int) -> torch.Tensor:
    """Paged (or dense) kv and a page table ``[B, n_kv, P_sel]`` -> the
    selected pages' rows ``[B, n_kv, P_sel * page_size, D]`` (the reference
    gather; the kernels read the pages in place)."""
    paged = as_paged(kv, page_size)
    B, n_kv, _, ps, D = paged.shape
    idx = page_table.long()[..., None, None].expand(-1, -1, -1, ps, D)
    return torch.gather(paged, 2, idx).reshape(B, n_kv, -1, D)


def dense_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           seq_len=None) -> torch.Tensor:
    """Full-attention decode oracle: q ``[B, n_q, D]`` over every key of
    dense k/v ``[B, n_kv, S, D]`` at a position ``< seq_len`` (all of them
    when ``seq_len`` is None) -> ``[B, n_q, D]`` in q's dtype."""
    B, n_q, D = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    g = n_q // n_kv
    qf = q.reshape(B, n_kv, g, D).to(torch.float32)
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, k.to(torch.float32))
    logits = logits / math.sqrt(D)
    if seq_len is not None:
        sl = torch.as_tensor(seq_len, dtype=torch.int32, device=q.device)
        sl = sl.reshape(-1, 1, 1, 1) if sl.ndim == 1 else sl
        mask = torch.arange(S, device=q.device)[None, None, None, :] < sl
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, v.to(torch.float32))
    return out.reshape(B, n_q, D).to(q.dtype)


def paged_attention_reference(
    q: torch.Tensor,               # [B, n_q, D]
    k: torch.Tensor,               # paged [B, n_kv, nP, page, D] or dense
    v: torch.Tensor,
    page_table: torch.Tensor,      # [B, n_kv, P_sel] int32
    page_valid: torch.Tensor,      # [B, n_kv, P_sel] bool
    page_size: int,
    seq_len: torch.Tensor,         # [B] int32 live tokens
) -> torch.Tensor:
    """Softmax over the selected tokens only; tokens of invalid pages and
    positions ``>= seq_len`` are masked.  -> ``[B, n_q, D]`` in q's dtype."""
    B, n_q, D = q.shape
    kp, vp = as_paged(k, page_size), as_paged(v, page_size)
    n_kv = kp.shape[1]
    g = n_q // n_kv
    P = page_table.shape[-1]
    sel_k = gather_pages(kp, page_table, page_size)
    sel_v = gather_pages(vp, page_table, page_size)
    pos = page_table[..., None] * page_size + torch.arange(
        page_size, device=q.device, dtype=torch.int32
    )
    pos = pos.reshape(B, n_kv, P * page_size)
    tok_ok = (pos < seq_len.to(torch.int32)[:, None, None]) & page_valid[
        ..., None
    ].expand(-1, -1, -1, page_size).reshape(B, n_kv, P * page_size)
    qf = q.reshape(B, n_kv, g, D).to(torch.float32)
    logits = torch.einsum("bhgd,bhld->bhgl", qf, sel_k.to(torch.float32))
    logits = logits / math.sqrt(D)
    logits = torch.where(tok_ok[:, :, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgl,bhld->bhgd", probs, sel_v.to(torch.float32))
    return out.reshape(B, n_q, D).to(q.dtype)
