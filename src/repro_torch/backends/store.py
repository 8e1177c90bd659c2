"""Centroid-store construction and incremental maintenance (counterpart of
``repro.backends.store``).

Rank keys are built at every candidate block size from page-granular
(max, min, mean) statistics and each flat store row takes its head's size.
Codes are byte-identical to the JAX package.

Where JAX rebuilds a donated cache functionally, the port updates the store
tensors in place.  JAX's out-of-bounds scatter rows (dropped) and clamped
``dynamic_slice`` starts are written out here as explicit masks and clamps.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import SparseConfig
from repro_torch.core.centroids import padded_rank_key_width, rank_key_from_stats
from repro_torch.core.quantization import (
    affine_params_from_minmax,
    encode_affine,
    pack_split_half,
    store_bits,
    store_symmetric,
)
from repro_torch.core.stacked import LayoutArrays

BIG = 1e30


def _as_paged(k_cache: torch.Tensor, page: int) -> torch.Tensor:
    if k_cache.ndim == 4:
        B, n_kv, S, hd = k_cache.shape
        return k_cache.reshape(B, n_kv, S // page, page, hd)
    return k_cache


def _rank_key(mx, mn, mean, method: str, Dp: int) -> torch.Tensor:
    """Rank key from page statistics; arkvale's radius is the half-diagonal
    of the block's bounding box."""
    radius = None
    if method == "arkvale":
        radius = 0.5 * torch.linalg.vector_norm(mx - mn, dim=-1)
    return rank_key_from_stats(mx, mn, mean, radius, method, Dp)


def _selected_rank_keys(
    k_cache: torch.Tensor, la: LayoutArrays, sparse: SparseConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K cache -> per-head rank keys at each head's block size:
    ``(sel [B, n_kv, n_pages, Dp], nb_h [n_kv])``; the first ``nb_h[h]``
    rows of head ``h`` are its rank keys."""
    method = sparse.centroid_method
    page = sparse.page_size
    k_cache = _as_paged(k_cache, page)
    B, n_kv, n_pages, _, hd = k_cache.shape
    Dp = padded_rank_key_width(hd, method)
    pages = k_cache.to(torch.float32)
    pmax, pmin = pages.amax(dim=3), pages.amin(dim=3)
    pmean = pages.mean(dim=3) if method == "mean" else None
    bsz = la.block_sizes
    sel = torch.zeros((B, n_kv, n_pages, Dp), dtype=torch.float32,
                      device=k_cache.device)
    nb_h = torch.zeros((n_kv,), dtype=torch.int32, device=k_cache.device)
    for c in sparse.candidate_block_sizes:
        group = c // page
        nb = n_pages // group
        shp = (B, n_kv, nb, group, hd)
        mx = pmax.reshape(shp).amax(dim=3)
        mn = pmin.reshape(shp).amin(dim=3)
        mean = pmean.reshape(shp).mean(dim=3) if pmean is not None else None
        rk = _rank_key(mx, mn, mean, method, Dp)
        rk = F.pad(rk, (0, 0, 0, n_pages - nb))
        hit = bsz == c
        sel = torch.where(hit[None, :, None, None], rk, sel)
        nb_h = torch.where(hit, (n_pages * page) // c, nb_h)
    return sel, nb_h


def _row_heads(la: LayoutArrays, k_pages: int):
    """Per flat row: (owning head, block index within the head, clamped)."""
    rows = la.total_rows
    row_head = torch.repeat_interleave(la.tile_head.long(), la.tile_rows)[:rows]
    row_j = torch.arange(rows, device=row_head.device) - la.row_offsets.long()[row_head]
    return row_head, torch.clamp(row_j, 0, k_pages - 1)


def build_store_codes(
    k_cache: torch.Tensor,
    la: LayoutArrays,
    sparse: SparseConfig,
    quant: Optional[str] = None,
    sel_nb=None,
):
    """K cache (paged or dense) -> decode :class:`CentroidStore` for one
    layer: per-(sequence, head, channel) affine params over the head's real
    blocks, codes in the flattened ragged row layout."""
    from repro_torch.backends.base import CentroidStore

    quant = sparse.quant if quant is None else quant
    bits, symmetric = store_bits(quant), store_symmetric(quant)
    if bits not in (0, 4, 8):
        raise ValueError(
            f"centroid store supports none/int8/int4 schemes, got {quant!r}"
        )
    sel, nb_h = _selected_rank_keys(k_cache, la, sparse) if sel_nb is None else sel_nb
    B, n_kv, n_pages, Dp = sel.shape
    if bits == 0:
        scale = torch.ones((B, n_kv, Dp), dtype=torch.float32, device=sel.device)
        zero = torch.zeros_like(scale)
    else:
        blk_valid = (
            torch.arange(n_pages, device=sel.device)[None, :] < nb_h[:, None]
        )[None, :, :, None]
        xmin = torch.where(blk_valid, sel, BIG).amin(dim=2)
        xmax = torch.where(blk_valid, sel, -BIG).amax(dim=2)
        scale, zero = affine_params_from_minmax(xmin, xmax, bits, symmetric)
    row_head, row_j = _row_heads(la, n_pages)
    rk_rows = sel[:, row_head, row_j]                         # [B, rows, Dp]
    if bits == 0:
        codes = rk_rows
    else:
        codes = encode_affine(
            rk_rows, scale[:, row_head], zero[:, row_head], bits, symmetric
        )
        if bits == 4:
            codes = pack_split_half(codes)
    return CentroidStore(codes.contiguous(), scale, zero, bits, symmetric)


def _encode_score_rows(rk_rows: torch.Tensor, bits: int, symmetric: bool):
    """Rank-key rows ``[..., Dp]`` -> per-ROW affine codes: a row's bytes
    depend only on its own block's keys, which makes chunked sparse prefill
    token-identical to single-shot."""
    if bits == 0:
        shp = rk_rows.shape[:-1] + (1,)
        return (
            rk_rows.to(torch.float32),
            torch.ones(shp, dtype=torch.float32, device=rk_rows.device),
            torch.zeros(shp, dtype=torch.float32, device=rk_rows.device),
        )
    xmin = rk_rows.amin(dim=-1, keepdim=True)
    xmax = rk_rows.amax(dim=-1, keepdim=True)
    scale, zero = affine_params_from_minmax(xmin, xmax, bits, symmetric)
    codes = encode_affine(rk_rows, scale, zero, bits, symmetric)
    if bits == 4:
        codes = pack_split_half(codes)
    return codes, scale, zero


def build_score_rows(
    k_cache: torch.Tensor,
    la: LayoutArrays,
    sparse: SparseConfig,
    quant: Optional[str] = None,
    sel_nb=None,
):
    """Full-sequence prefill scoring segment -> ``(codes [B, rows, Cw],
    scale [B, rows, 1], zero [B, rows, 1])``."""
    quant = sparse.quant if quant is None else quant
    bits, symmetric = store_bits(quant), store_symmetric(quant)
    sel, _ = _selected_rank_keys(k_cache, la, sparse) if sel_nb is None else sel_nb
    row_head, row_j = _row_heads(la, sel.shape[2])
    codes, scale, zero = _encode_score_rows(sel[:, row_head, row_j], bits, symmetric)
    return codes.contiguous(), scale.contiguous(), zero.contiguous()


def refresh_score_rows(
    codes: torch.Tensor,           # [B, rows, Cw]   updated in place
    scale: torch.Tensor,           # [B, rows, 1]    updated in place
    zero: torch.Tensor,
    k_cache: torch.Tensor,         # paged [B, n_kv, n_pages, page, hd]
    la: LayoutArrays,
    chunk_start: int,              # first token of the chunk
    chunk_end: int,                # one past the chunk's last token
    sparse: SparseConfig,
    window: int,                   # token window, multiple of Bmax
    bits: int,
    symmetric: bool,
):
    """Re-encode, in place, the score rows of every block COMPLETED by the
    chunk ``[chunk_start, chunk_end)`` from a ``window``-token slice of K.
    Blocks still partial at ``chunk_end`` keep their stale bytes."""
    page = sparse.page_size
    B, n_kv, n_pages, _, hd = k_cache.shape
    S_max = n_pages * page
    bmax = sparse.max_block_size
    assert window % bmax == 0 and bmax <= window <= S_max, (window, bmax, S_max)
    # JAX's dynamic_slice clamps its start into range: done explicitly here.
    w0 = min(max((chunk_start - bmax) // bmax * bmax, 0), S_max - window)
    win = k_cache[:, :, w0 // page:(w0 + window) // page]
    sel_win, _ = _selected_rank_keys(win, la, sparse)         # [B, n_kv, nW, Dp]
    new_codes, new_scale, new_zero = _encode_score_rows(sel_win, bits, symmetric)

    lay = la.host
    n_win = window // page
    rows, src = [], []
    for h, (bs, off) in enumerate(zip(lay.block_sizes, lay.offsets)):
        for i in range(window // bs):
            jg = w0 // bs + i
            end_tok = (jg + 1) * bs
            # JAX sends the other rows out of bounds, where they are dropped.
            if chunk_start < end_tok <= chunk_end and off + jg < la.total_rows:
                rows.append(off + jg)
                src.append(h * n_win + i)
    if not rows:
        return codes, scale, zero
    dev = codes.device
    rows_t = torch.tensor(rows, dtype=torch.long, device=dev)
    src_t = torch.tensor(src, dtype=torch.long, device=dev)

    def flat(a):
        return a.reshape(B, n_kv * n_win, a.shape[-1])[:, src_t]

    codes[:, rows_t] = flat(new_codes).to(codes.dtype)
    if bits:
        scale[:, rows_t] = flat(new_scale)
        zero[:, rows_t] = flat(new_zero)
    return codes, scale, zero


def refresh_tail_codes(
    store,                         # CentroidStore; codes updated in place
    k_cache: torch.Tensor,         # paged [B, n_kv, n_pages, page, hd]
    la: LayoutArrays,
    seq_len: torch.Tensor,         # [B] int32 position of the newest token
    sparse: SparseConfig,
) -> torch.Tensor:
    """Recompute and requantize (frozen affine params), in place, the
    rank-key row of the block holding the newest token, for every head.
    Positions past ``seq_len`` are neutralized (-BIG/+BIG, zero weight)."""
    codes, scale, zero = store.codes, store.scale, store.zero
    method = sparse.centroid_method
    page = sparse.page_size
    k_cache = _as_paged(k_cache, page)
    B, n_kv, n_pages, _, hd = k_cache.shape
    Dp = padded_rank_key_width(hd, method)
    Wmax = max(sparse.candidate_block_sizes)
    wp = Wmax // page
    dev = k_cache.device
    seq_len = seq_len.to(torch.int64)
    w0 = (seq_len // Wmax) * Wmax                             # [B]
    # JAX's dynamic_slice clamps the window start; pos keeps the unclamped w0.
    p0 = torch.clamp(w0 // page, max=n_pages - wp)
    pidx = p0[:, None] + torch.arange(wp, device=dev)         # [B, wp]
    bidx = torch.arange(B, device=dev)
    win = k_cache[bidx[:, None], :, pidx]                     # [B, wp, n_kv, ps, hd]
    win = win.permute(0, 2, 1, 3, 4).reshape(B, n_kv, Wmax, hd).to(torch.float32)
    pos = w0[:, None] + torch.arange(Wmax, device=dev)[None]
    ok = (pos <= seq_len[:, None])[:, None, :, None]          # [B, 1, Wmax, 1]

    bsz = la.block_sizes
    sel = torch.zeros((B, n_kv, Dp), dtype=torch.float32, device=dev)
    for c in sparse.candidate_block_sizes:
        n = Wmax // c
        wm = win.reshape(B, n_kv, n, c, hd)
        okm = ok.reshape(B, 1, n, c, 1)
        mx = torch.where(okm, wm, -BIG).amax(dim=3)
        mn = torch.where(okm, wm, BIG).amin(dim=3)
        mean = None
        if method == "mean":
            cnt = torch.clamp_min(okm.sum(dim=3), 1)
            mean = torch.where(okm, wm, 0.0).sum(dim=3) / cnt
        slot = ((seq_len % Wmax) // c)[:, None, None, None].expand(B, n_kv, 1, hd)
        take = lambda a: torch.gather(a, 2, slot)[:, :, 0]
        rk = _rank_key(take(mx), take(mn), take(mean) if mean is not None else None,
                       method, Dp)
        sel = torch.where((bsz == c)[None, :, None], rk, sel)

    if store.bits == 0:
        new_codes = sel
    else:
        qv = encode_affine(sel, scale, zero, store.bits, store.symmetric)
        new_codes = pack_split_half(qv) if store.bits == 4 else qv
    rows = la.row_offsets.long()[None, :] + seq_len[:, None] // bsz.long()[None, :]
    # JAX drops out-of-bounds rows; keep the old bytes there instead.
    in_range = rows < codes.shape[1]
    rows = torch.clamp(rows, max=codes.shape[1] - 1)
    bb = bidx[:, None].expand(B, n_kv)
    old = codes[bb, rows]
    codes[bb, rows] = torch.where(in_range[..., None], new_codes.to(codes.dtype), old)
    return codes
