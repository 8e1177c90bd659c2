"""Plain PyTorch versions of the kernels' arithmetic (counterpart of
``repro.kernels.ref``).

Block scores are computed as a broadcast multiply and a sum over the
channel axis (:func:`row_scores`), never as a matmul: the reduction order
then does not depend on a row's position, so identical centroid rows (common
under INT4) score identically and ties keep their lowest-index-first order.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.centroids import build_rank_keys
from repro_torch.core.quantization import decode_affine, unpack_split_half
from repro_torch.core.sparse_attention import paged_attention_reference
from repro_torch.core.stacked import LayoutArrays

NEG_INF = -1e30

#: elements of one broadcast product chunk in :func:`row_scores`.
_CHUNK_ELEMS = 1 << 25
#: f32 logits of one query-head chunk in :func:`flash_attention_ref` (1 GiB)
_LOGIT_ELEMS = 1 << 28


def row_scores(rk: torch.Tensor, rq: torch.Tensor) -> torch.Tensor:
    """rk ``[..., M, Dp]``, rq ``[..., R, Dp]`` -> ``[..., R, M]`` with
    ``out[..., r, m] = sum_c rk[..., m, c] * rq[..., r, c]`` (f32)."""
    rk = rk.to(torch.float32)
    rq = rq.to(torch.float32)
    M, Dp = rk.shape[-2:]
    R = rq.shape[-2]
    lead = torch.broadcast_shapes(rk.shape[:-2], rq.shape[:-2])
    per_row = max(1, math.prod(lead) * R * Dp)
    step = max(1, _CHUNK_ELEMS // per_row)
    outs = []
    for m0 in range(0, M, step):
        blk = rk[..., m0:m0 + step, :]
        outs.append((blk.unsqueeze(-3) * rq.unsqueeze(-2)).sum(-1))
    return torch.cat(outs, dim=-1)


def dequant_store_rows(
    codes: torch.Tensor,           # [B, rows, Cw]
    scale: torch.Tensor,           # [B, n_kv, Dp] per-(sequence, head, channel)
    zero: torch.Tensor,
    la: LayoutArrays,
    bits: int,
    symmetric: bool,
) -> torch.Tensor:
    """Decode store -> f32 rank keys ``[B, rows, Dp]`` (the bytes the fused
    decode kernel dequantizes in registers)."""
    if bits == 0:
        return codes.to(torch.float32)
    unpacked = unpack_split_half(codes) if bits == 4 else codes
    row_head = store_row_head(la.tile_head, la.tile_rows, codes.shape[1])
    return decode_affine(
        unpacked, scale[:, row_head], zero[:, row_head], bits, symmetric
    )


def store_row_head(tile_head: torch.Tensor, tile_rows: int, rows: int) -> torch.Tensor:
    """The kv head owning each of the store's ``rows`` rows (int64)."""
    return torch.repeat_interleave(tile_head.long(), tile_rows)[:rows]


def centroid_scores_ref(
    rq: torch.Tensor,              # [B, n_kv * g, Dp] f32 rank queries
    codes: torch.Tensor,           # [B, rows, Cw] store codes (f32 when bits 0)
    scale,                         # [B, n_kv, Dp] f32 (None when bits 0)
    zero,
    tile_head: torch.Tensor,       # [n_tiles] int32 tile -> head
    tile_rows: int,
    bits: int,
    symmetric: bool,
    n_kv: Optional[int] = None,    # needed when bits == 0 (no scale)
) -> torch.Tensor:
    """Flat block scores ``[B, rows]``: each store row dequantized, dotted
    with every rank query of its head's GQA group (:func:`row_scores`'s
    broadcast-sum order), max over the group."""
    B, n_q, Dp = rq.shape
    n_kv = scale.shape[1] if bits else n_kv
    head = store_row_head(tile_head, tile_rows, codes.shape[1])
    if bits == 0:
        rows = codes.to(torch.float32)
    else:
        unpacked = unpack_split_half(codes) if bits == 4 else codes
        rows = decode_affine(unpacked, scale[:, head], zero[:, head], bits,
                             symmetric)
    rq4 = rq.to(torch.float32).reshape(B, n_kv, n_q // n_kv, Dp)
    s = row_scores(rows[:, :, None, :], rq4[:, head])         # [B, R, g, 1]
    return s.squeeze(-1).amax(dim=-1)


def paged_attention_ref(q, k_pages, v_pages, page_table, page_valid, seq_len,
                        page_size):
    """Paged decode attention over the selected pages (argument order of
    ``repro.kernels.ref.paged_attention_ref``)."""
    return paged_attention_reference(q, k_pages, v_pages, page_table,
                                     page_valid, page_size, seq_len)


def dequant_score_rows(
    codes: torch.Tensor,           # [B, rows, Cw]
    scale: torch.Tensor,           # [B, rows, 1] per-row
    zero: torch.Tensor,
    bits: int,
    symmetric: bool,
) -> torch.Tensor:
    """Per-ROW affine prefill score rows -> f32 rank keys ``[B, rows, Dp]``."""
    if bits == 0:
        return codes.to(torch.float32)
    unpacked = unpack_split_half(codes) if bits == 4 else codes
    return decode_affine(unpacked, scale, zero, bits, symmetric)


def sparse_prefill_ref(
    q: torch.Tensor,               # [B, n_kv, nQB, g, BQ, D]
    rq: torch.Tensor,              # [B, n_kv, nQB, g, BQ, Dp]
    k_pages: torch.Tensor,         # [B, n_kv, n_pages, page, D]
    v_pages: torch.Tensor,
    rank_rows: torch.Tensor,       # [B, total_rows, Dp] f32 (dequantized)
    la: LayoutArrays,              # one layer
    k_sel: torch.Tensor,           # [H] int32 prefill-scaled top-K
    n_valid: torch.Tensor,         # [B] int32
    qb0: int,
    block_q: int,
    sink_pages: int,
    local_pages: int,
    extras: bool = False,
):
    """Forced (sink + local/diagonal) union top-K scored blocks per (b, head,
    query block), then dense masked softmax over the selected blocks' keys.
    -> (out [B, n_kv, nQB, g, BQ, D], n_attended [B, n_kv, nQB] int32), plus
    with ``extras`` a dict of the selection (``selected``, ``cand``,
    ``cand_scores`` ``[B, n_kv, nQB, M]``), the live query rows per cell
    (``live_rows`` ``[B, nQB]``) and the causal (live row, selected key)
    pairs per cell (``pairs`` ``[B, n_kv, nQB]``)."""
    B, n_kv, nQB, g, BQ, _ = q.shape
    dev = q.device
    M = la.max_blocks
    ps = la.page_size
    bsz = la.block_sizes.to(torch.int32)
    nv = n_valid.to(torch.int32)

    rk = rank_rows[:, la.scatter_rows.long()]                 # [B, H, M, Dp]
    qb_idx = qb0 + torch.arange(nQB, device=dev, dtype=torch.int32)
    qpos = qb_idx[:, None] * block_q + torch.arange(
        BQ, device=dev, dtype=torch.int32
    )[None, :]                                                # [nQB, BQ]
    Dp = rq.shape[-1]
    s = row_scores(rk, rq.reshape(B, n_kv, nQB * g * BQ, Dp))
    s = s.reshape(B, n_kv, nQB, g, BQ, M)
    live_q = qpos[None, None, :, None, :, None] < nv[:, None, None, None, None, None]
    s = torch.where(live_q, s, NEG_INF).amax(dim=(3, 4))      # [B, H, nQB, M]

    starts = la.block_starts[None, :, None, :]                # [1, H, 1, M]
    q_start = qb_idx * block_q
    q_end = torch.minimum(q_start[None, :] + block_q, nv[:, None]) - 1
    causal = (
        la.pad_mask[None, :, None, :]
        & (starts <= q_end[:, None, :, None])
        & (starts < nv[:, None, None, None])
    )
    forced = causal & (starts < sink_pages * ps)
    lo = (q_start - local_pages * ps)[None, None, :, None]
    forced = forced | (causal & (starts + bsz[None, :, None, None] > lo))
    cand = causal & ~forced

    masked = torch.where(cand, s, NEG_INF)
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    slot_ok = (
        torch.arange(M, device=dev)[None, None, None, :]
        < k_sel[None, :, None, None]
    ) & (vals > NEG_INF / 2)
    scored = torch.zeros_like(cand).scatter(-1, idx, slot_ok)
    qb_live = q_start[None, None, :, None] < nv[:, None, None, None]
    selected = (forced | scored) & qb_live                    # [B, H, nQB, M]
    n_att = selected.sum(-1).to(torch.int32)

    out, pairs = prefill_attention_ref(q, k_pages, v_pages, selected, la, nv, qb0,
                                       block_q, pairs=extras)
    if not extras:
        return out, n_att
    return out, n_att, {
        "selected": selected, "cand": cand, "cand_scores": masked,
        "live_rows": g * (qpos[None] < nv[:, None, None]).sum(-1),
        "pairs": pairs,
    }


def prefill_attention_ref(q, k_pages, v_pages, selected, la, n_valid, qb0: int,
                          block_q: int, pairs: bool = False):
    """The attention of :func:`sparse_prefill_ref` over given selected
    blocks ``[B, n_kv, nQB, M]`` bool: per query block, dense masked softmax
    over the selected blocks' keys at positions up to the query's and below
    ``n_valid`` (f32, a row with no such key gives 0) -> (out like q, and
    with ``pairs`` the causal (live row, selected key) pairs per cell
    ``[B, n_kv, nQB]``, else None)."""
    B, n_kv, nQB, g, BQ, D = q.shape
    dev = q.device
    M = la.max_blocks
    S = k_pages.shape[2] * la.page_size
    bsz = la.block_sizes.to(torch.int32)
    nv = n_valid.to(torch.int32)
    qb_idx = qb0 + torch.arange(nQB, device=dev, dtype=torch.int32)
    qpos = qb_idx[:, None] * block_q + torch.arange(
        BQ, device=dev, dtype=torch.int32
    )[None, :]                                                # [nQB, BQ]
    key_block = torch.clamp_max(
        torch.arange(S, device=dev, dtype=torch.int32)[None, :] // bsz[:, None],
        M - 1,
    ).long()                                                  # [H, S]
    kd = k_pages.reshape(B, n_kv, S, D).to(torch.float32)
    vd = v_pages.reshape(B, n_kv, S, D).to(torch.float32)
    pos = torch.arange(S, device=dev, dtype=torch.int32)
    outs, n_pairs = [], []
    for qb in range(nQB):
        sel_k = torch.gather(
            selected[:, :, qb], 2, key_block[None].expand(B, -1, -1)
        )                                                     # [B, H, S]
        qf = q[:, :, qb].to(torch.float32)                    # [B, H, g, BQ, D]
        logits = torch.einsum("bhgqd,bhsd->bhgqs", qf, kd) / math.sqrt(D)
        ok = (
            sel_k[:, :, None, None, :]
            & (pos[None, None, None, None, :] <= qpos[qb][None, None, None, :, None])
            & (pos[None, None, None, None, :] < nv[:, None, None, None, None])
        )
        logits = torch.where(ok, logits, NEG_INF)
        any_ok = ok.any(dim=-1, keepdim=True)
        probs = torch.where(any_ok, torch.softmax(logits, dim=-1), 0.0)
        outs.append(torch.einsum("bhgqs,bhsd->bhgqd", probs, vd))
        if pairs:
            live = (qpos[qb][None, :] < nv[:, None])[:, None, None, :, None]
            n_pairs.append(g * (ok & live).sum(dim=(2, 3, 4)))
    out = torch.stack(outs, dim=2).to(q.dtype)
    return out, torch.stack(n_pairs, dim=2) if pairs else None


def pool_rank_keys_ref(keys: torch.Tensor, block_size: int, method: str) -> torch.Tensor:
    """keys ``[B, H, S, D]`` -> lane-padded f32 rank keys ``[B, H, S / bs, Dp]``."""
    return build_rank_keys(keys, block_size, method, pad=True)


def sortable_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 key in the order of the kernels' sortable-u32 encoding
    (the float order, with -0.0 just below +0.0)."""
    i = x.to(torch.float32).view(torch.int32).to(torch.int64)
    return torch.where(i >= 0, i + (1 << 31), -i - 1)


def from_sortable_key(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`sortable_key`."""
    i = torch.where(key >= (1 << 31), key - (1 << 31), -key - 1)
    return i.to(torch.int32).view(torch.float32)


def topk_threshold_ref(scores: torch.Tensor, k_per_head: torch.Tensor):
    """scores ``[B, H, M]`` -> (the K_h-th largest score ``[B, H]`` f32, the
    count of scores strictly above it ``[B, H]`` int32), ranked by
    :func:`sortable_key` as the kernels' threshold search ranks them."""
    B, H, M = scores.shape
    key = sortable_key(scores)
    desc = torch.sort(key, dim=-1, descending=True).values
    kk = (k_per_head.to(torch.int64) - 1).reshape(1, H, 1).expand(B, H, 1)
    thr = torch.gather(desc, -1, kk)
    return from_sortable_key(thr[..., 0]), (key > thr).sum(-1).to(torch.int32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        k_len=None) -> torch.Tensor:
    """q ``[B, Hq, Sq, D]`` at positions ``q_offset + i``, k/v
    ``[B, Hkv, Sk, D]`` -> ``[B, Hq, Sq, D]`` in q's dtype: f32 softmax
    attention, query head h reading kv head ``h // g``, keys at or past
    ``k_len`` (None: Sk; an int or a ``[B]`` tensor) and, when ``causal``,
    keys past the query's position at -1e30.  Query heads go in chunks so
    that the f32 logits stay within ``_LOGIT_ELEMS`` elements."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    g = Hq // k.shape[1]
    step = max(1, _LOGIT_ELEMS // (B * Sq * Sk))
    keep = None
    if causal:
        pos = q_offset + torch.arange(Sq, device=q.device)
        keep = torch.arange(Sk, device=q.device)[None, :] <= pos[:, None]
    if k_len is not None:
        kl = torch.as_tensor(k_len, device=q.device).reshape(-1, 1, 1, 1)
        live = torch.arange(Sk, device=q.device)[None, None, None, :] < kl
        keep = live if keep is None else keep & live
    outs = []
    for h0 in range(0, Hq, step):
        hs = torch.arange(h0, min(Hq, h0 + step), device=q.device)
        qf = q[:, hs].to(torch.float32)
        kf = k[:, hs // g].to(torch.float32)
        vf = v[:, hs // g].to(torch.float32)
        logits = torch.matmul(qf, kf.transpose(-1, -2)) / math.sqrt(D)
        if keep is not None:
            logits = torch.where(keep, logits, NEG_INF)
        outs.append(torch.matmul(torch.softmax(logits, dim=-1), vf).to(q.dtype))
    return torch.cat(outs, dim=1)
