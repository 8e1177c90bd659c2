"""Adaptive Top-K block selection + page-table expansion (counterpart of
``repro.core.selection``); the plain version of the fused decode kernel's
selection stage, and the selected / predicted page masks tiered KV memory
reads (:func:`selected_page_masks`).

Head h selects ``K_h = T / B_h`` blocks; block ``b`` of a head with
``s = B_h / page`` pages per block covers pages ``[b*s, b*s + s)``, so the
page table is a dense ``[B, H, selected_pages]`` tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.stacked import LayoutArrays

NEG_INF = -1e30
POS_INF = 1e30


def mask_and_pin_scores(
    scores: torch.Tensor,          # [B, H, M]
    la: LayoutArrays,
    seq_len: torch.Tensor,         # [B] int32 live tokens
    sink_pages: int = 1,
    local_pages: int = 4,
) -> torch.Tensor:
    """Blocks at or past ``seq_len`` -> -inf; the first ``sink_pages`` and
    last ``local_pages`` pages of the live context -> +inf (always kept)."""
    starts = la.block_starts                                    # [H, M]
    bsz = la.block_sizes[:, None]
    sl = seq_len.to(torch.int32)[:, None, None]                 # [B, 1, 1]
    valid = (starts < sl) & la.pad_mask
    scores = torch.where(valid, scores, NEG_INF)
    if sink_pages > 0:
        sink_tok = sink_pages * la.page_size
        pin = (starts < torch.clamp_max(sl, sink_tok)) & la.pad_mask
        scores = torch.where(pin, POS_INF, scores)
    if local_pages > 0:
        lo = torch.clamp_min(sl - local_pages * la.page_size, 0)
        pin = (starts + bsz > lo) & valid
        scores = torch.where(pin, POS_INF, scores)
    return scores


def rank_blocks(
    scores: torch.Tensor,
    la: LayoutArrays,
    seq_len: torch.Tensor,
    sink_pages: int = 1,
    local_pages: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask/pin and rank -> ``(vals, idx)`` of the ``max_top_k`` best blocks,
    each ``[B, H, kmax]``.  A stable descending sort keeps the lower index
    first on ties, as ``lax.top_k`` does (``torch.topk`` promises no order)."""
    masked = mask_and_pin_scores(scores, la, seq_len, sink_pages, local_pages)
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return vals[..., : la.max_top_k], idx[..., : la.max_top_k].to(torch.int32)


def select_page_table(
    scores: torch.Tensor,
    la: LayoutArrays,
    seq_len: torch.Tensor,
    sink_pages: int = 1,
    local_pages: int = 4,
    ranked: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores ``[B, H, M]`` -> (page_table ``[B, H, P_sel]`` int32,
    page_valid ``[B, H, P_sel]`` bool), slots in rank order."""
    B = scores.shape[0]
    if ranked is None:
        ranked = rank_blocks(scores, la, seq_len, sink_pages, local_pages)
    vals, idx = ranked
    slot = la.slot_map.long().expand(B, -1, -1)
    sel_blocks = torch.gather(idx, 2, slot)
    sel_vals = torch.gather(vals, 2, slot)
    table = sel_blocks * la.pages_per_block[None, :, None] + la.within_map[None]
    table = torch.clamp(table, 0, la.n_pages - 1)
    return table.to(torch.int32), sel_vals > NEG_INF / 2


def selected_page_masks(
    scores: torch.Tensor,          # [B, H, M]
    la: LayoutArrays,
    seq_len: torch.Tensor,         # [B] int32 live tokens
    sink_pages: int = 1,
    local_pages: int = 4,
    margin_blocks: int = 0,
    max_pages_per_block: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores ``[B, H, max_blocks]`` -> ``(selected, predicted)`` bool page
    masks, each ``[B, n_pages]`` (OR over heads).

    ``selected`` is exactly the page set :func:`select_page_table` sends to
    the attention stage: tiered KV memory compares it with the host-resident
    pages to detect misses.  ``predicted`` widens each head's cutoff to
    ``K_h + margin_blocks`` in the same stable descending order as
    :func:`rank_blocks` (lower index first on ties, as ``lax.top_k``): its
    extra pages are the ranks just below the cutoff, the likely targets when
    selection drifts next step (the prefetch predictor).  ``predicted``
    always contains ``selected``.  ``max_pages_per_block`` must bound
    ``B_h / page_size`` over heads (callers pass ``max_block_size //
    page_size``).  No host sync and no data-dependent shape, so it runs
    inside a captured decode step."""
    B, H, M = scores.shape
    n_pages = la.n_pages
    masked = mask_and_pin_scores(scores, la, seq_len, sink_pages, local_pages)
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    kmax = la.max_top_k
    table, valid = select_page_table(
        scores, la, seq_len, sink_pages, local_pages,
        ranked=(vals[..., :kmax], idx[..., :kmax].to(torch.int32)))
    selected = torch.zeros((B, n_pages), dtype=torch.int32, device=scores.device)
    selected.scatter_add_(1, table.long().reshape(B, -1),
                          valid.to(torch.int32).reshape(B, -1))
    k_wide = min(kmax + margin_blocks, M)
    vals, idx = vals[..., :k_wide], idx[..., :k_wide]
    cutoff = la.top_k[None, :, None] + margin_blocks                # [1, H, 1]
    ok = ((torch.arange(k_wide, device=scores.device)[None, None, :] < cutoff)
          & (vals > NEG_INF / 2))
    ppb = la.pages_per_block[None, :, None]                         # [1, H, 1]
    predicted = torch.zeros((B, n_pages), dtype=torch.int32, device=scores.device)
    for j in range(max_pages_per_block):
        page = torch.clamp(idx * ppb + j, 0, n_pages - 1)
        hit = ok & (j < ppb)
        predicted.scatter_add_(1, page.long().reshape(B, -1),
                               hit.to(torch.int32).reshape(B, -1))
    selected = selected > 0
    return selected, (predicted > 0) | selected


def selection_telemetry(
    scores: torch.Tensor,
    la: LayoutArrays,
    seq_len: Optional[torch.Tensor] = None,
    sink_pages: int = 1,
    local_pages: int = 4,
    ranked: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """scores ``[B, H, max_blocks]`` -> per-slot sparsity counters ``[B, 4]``
    int32: ``[blocks selected, KV pages gathered (summed per head), forced
    (pinned) blocks, total top-K block budget]``, in the column order of
    :mod:`repro_torch.obs.telemetry`.  Pass the decode's own
    :func:`rank_blocks` result as ``ranked`` so the counts are those of the
    page table the attention stage reads; they depend only on the live
    lengths and the layout, not on the scores."""
    B = scores.shape[0]
    if seq_len is None:
        seq_len = torch.full((B,), la.context_len, dtype=torch.int32,
                             device=scores.device)
    if ranked is None:
        ranked = rank_blocks(scores, la, seq_len, sink_pages, local_pages)
    vals, _ = ranked                                            # [B, H, kmax]
    within_k = (
        torch.arange(la.max_top_k, device=scores.device)[None, None, :]
        < la.top_k[None, :, None]
    )
    valid = within_k & (vals > NEG_INF / 2)
    forced = within_k & (vals > POS_INF / 2)
    n_blocks = valid.sum(dim=(1, 2))
    n_pages = (valid * la.pages_per_block[None, :, None]).sum(dim=(1, 2))
    n_forced = forced.sum(dim=(1, 2))
    budget = la.top_k.sum().expand(B)
    return torch.stack([n_blocks, n_pages, n_forced, budget], dim=-1).to(torch.int32)


def pages_to_token_mask(
    page_table: torch.Tensor,      # [B, H, P_sel]
    page_valid: torch.Tensor,      # [B, H, P_sel] bool
    la: LayoutArrays,
) -> torch.Tensor:
    """Token coverage of a page table -> ``[B, H, context_len]`` bool (recall
    instrumentation; never on the serving path).  A slot counts when it is
    valid and its page lies in range, as JAX's one-hot leaves out-of-range
    pages out."""
    n_pages = la.n_pages
    tbl = page_table.long()
    ok = page_valid & (tbl >= 0) & (tbl < n_pages)
    hits = torch.zeros(page_table.shape[:2] + (n_pages,), dtype=torch.int32,
                       device=page_table.device)
    hits.scatter_add_(-1, tbl.clamp(0, n_pages - 1), ok.to(torch.int32))
    return (hits > 0).repeat_interleave(la.page_size, dim=-1)
