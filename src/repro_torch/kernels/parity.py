"""Hold each CUDA kernel against its plain version on the same inputs.

Selection is exact up to near ties: the kernel and the plain version sum a
block's score in different orders, so two blocks whose scores are within
one or two ulps can swap places.  The rule: a block selected by only one of
the two versions must be a scored block (never a forced one) within
``TIE_RTOL`` (relative) of its head's K-th score.

Outputs are compared for every (sequence, head, query block) where the
selections agree.  Both versions accumulate in f32 and round to bf16 once,
so an element may differ by one bf16 rounding step: ``|kernel - plain| <=
OUT_ATOL + OUT_RTOL * |plain|``.  Each output row (one query head of one
sequence, at one query position) must also have a relative L2 error of at
most ``REL_L2``.  That catches a dropped page: leaving out 16 of 4096
attended tokens moves a row by about sqrt(16 / 4096) = 6% (relative L2),
and a flash rescale error by far more.

Block scores of the staged scoring kernel must lie within ``SCORE_RTOL``
of the plain version's, relative to the largest |score| of their (sequence,
head): both accumulate in f32, in different orders.

Pooled rank keys: quest (a max and a min) bitwise equal; mean and arkvale
within ``POOL_RTOL`` of their row's largest magnitude (f32 sums in other
orders).  Top-K thresholds and counts: bitwise equal, and the set they
define (every score above the threshold, then the first ``K - count`` ties
in index order) equal to a stable descending sort's first K.  Dense flash
attention: every output row under the bf16 output rule above.

Raises ``AssertionError`` on a violation; returns the errors and the number
of near ties.
"""
from __future__ import annotations

import torch

from repro_torch.core.selection import mask_and_pin_scores, select_page_table
from repro_torch.kernels import block_centroid, ops, ref, topk_threshold

TIE_RTOL = 1e-5
#: staged scores: |kernel - plain| <= SCORE_RTOL * max |plain| of the
#: (sequence, head); a sum of Dp = 256 f32 products in two orders differs by
#: a few ulps of its largest partial sums, far below this
SCORE_RTOL = 1e-5
#: one bf16 rounding step (relative), and the floor for outputs near zero
OUT_RTOL = 2.0 ** -7
OUT_ATOL = 1e-4
REL_L2 = 1e-2
#: pooled mean / arkvale rank keys: |kernel - plain| <= POOL_RTOL * max
#: |plain| of the row; a sum of at most 64 tokens (mean) or 256 squares
#: (radius) in two orders differs by a few ulps
POOL_RTOL = 1e-6
#: callers scale random queries by this so that attention logits have
#: standard deviation 1.5: outputs peak more than at 1.0 (a flash rescale
#: error moves them further), while a page left out still moves most rows
#: by more than REL_L2 (at 2.0 and above it mostly would not)
QSCALE = 1.5


def _split_kw(n_split):
    """The kernel wrapper's forced split count, if one is given."""
    return {} if n_split is None else {"n_split": n_split}


def _near(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs() <= TIE_RTOL * a.abs().clamp(min=1e-6)


def check_outputs(out_k, out_p, keep, what):
    """Compare kernel and plain outputs ``[..., D]`` on the rows where
    ``keep`` (``out.shape[:-1]``) holds -> (max abs error, max relative L2
    error, max share of the elementwise limit used)."""
    k, p = out_k.float()[keep], out_p.float()[keep]
    if not k.numel():
        return 0.0, 0.0, 0.0
    d = (k - p).abs()
    use = float((d / (OUT_ATOL + OUT_RTOL * p.abs())).max())
    rel = float((d.norm(dim=-1) / p.norm(dim=-1).clamp(min=1e-6)).max())
    err = float(d.max())
    assert use <= 1.0, (f"{what}: output error {err} exceeds {OUT_ATOL} + "
                        f"{OUT_RTOL} * |plain| ({use:.2f} of the limit)")
    assert rel <= REL_L2, f"{what}: relative L2 error {rel} > {REL_L2}"
    return err, rel, use


def compare_fused_decode(q, rq, k, v, store, la, sparse, seq_len, n_split=None):
    """Fused kernel (``n_split`` slot runs, default its plan) against its
    plain version -> {"max_abs_err", "max_rel_l2", "tol_use", "near_ties",
    "tie_heads", "kernel": (out, table, valid), "plain": (out, table,
    valid)}; ``page_valid`` must match exactly."""
    args = (q, rq, k, v, store, la, sparse.sink_pages, sparse.local_pages, seq_len)
    kernel = ops.fused_decode(*args, **_split_kw(n_split))
    plain = ops.fused_decode_reference(*args)
    torch.cuda.synchronize()
    res = hold_fused_decode(q, rq, store.codes, store.scale, store.zero, la,
                            store.bits, store.symmetric, sparse.sink_pages,
                            sparse.local_pages, seq_len, kernel, plain)
    return dict(res, kernel=kernel, plain=plain)


def decode_block_scores(rq, codes, scale, zero, la, bits, symmetric):
    """The plain version's block scores ``[B, H, M]`` of a decode step (each
    kv head's largest over its query group), before masking."""
    B, n_kv = rq.shape[0], la.n_heads
    g = rq.shape[1] // n_kv
    rows = ref.dequant_store_rows(codes, scale, zero, la, bits, symmetric)
    return ref.row_scores(rows[:, la.scatter_rows.long()],
                          rq.float().reshape(B, n_kv, g, -1)).amax(dim=2)


def hold_fused_decode(q, rq, codes, scale, zero, la, bits, symmetric,
                      sink_pages, local_pages, seq_len, kernel, plain):
    """Hold one fused decode call's outputs ``kernel`` = (out, table,
    valid) against the plain version's ``plain`` on the same inputs (the
    kernel wrapper's arguments): ``page_valid`` exactly, the page sets
    equal up to near ties, every output row of a head without one within
    the bf16 rule -> {"max_abs_err", "max_rel_l2", "tol_use", "near_ties",
    "tie_heads"}; raises ``AssertionError`` otherwise."""
    out_k, tbl_k, vld_k = kernel
    out_p, tbl_p, vld_p = plain
    assert torch.equal(vld_k, vld_p), "fused_decode: page_valid differs"
    g = q.shape[1] // la.n_heads
    s = decode_block_scores(rq, codes, scale, zero, la, bits, symmetric)
    diff = _selection_diff(s, la, sink_pages, local_pages, seq_len, tbl_k, tbl_p,
                           vld_k, "fused_decode")
    tie_heads = diff.any(-1)                                   # [B, H]
    keep = (~tie_heads).repeat_interleave(g, dim=1)            # [B, n_q]
    err, rel, use = check_outputs(out_k, out_p, keep, "fused_decode")
    return {"max_abs_err": err, "max_rel_l2": rel, "tol_use": use,
            "near_ties": int(diff.sum()), "tie_heads": int(tie_heads.sum())}


def _selection_diff(scores, la, sink_pages, local_pages, seq_len, tbl_k, tbl_p,
                    valid, what):
    """Blocks ``[B, H, M]`` that only one of two page tables (same
    ``valid``) selects; each must be a near tie of its head's K-th score
    under ``scores`` (the plain version's, before masking)."""
    B, n_kv, M = scores.shape
    s = mask_and_pin_scores(scores, la, seq_len, sink_pages, local_pages)
    thr = torch.sort(s, dim=-1, descending=True).values
    thr = thr.gather(-1, (la.top_k.long() - 1)[None, :, None].expand(B, -1, 1))
    ppb = la.pages_per_block.long()[None, :, None]

    def chosen(tbl):        # [B, H, M] selected live blocks
        sel = torch.zeros((B, n_kv, M), dtype=torch.bool, device=s.device)
        blk = torch.where(valid, tbl.long() // ppb, M)
        return sel.scatter(-1, blk.clamp(max=M - 1), valid & (blk < M))

    diff = chosen(tbl_k) ^ chosen(tbl_p)
    ok = _near(s, thr.expand_as(s)) | ~diff
    assert bool(ok.all()), f"{what}: a block selected by one version only is not a near tie"
    return diff


def page_sets_equal(tbl_a, vld_a, tbl_b, vld_b) -> bool:
    """Whether two page tables ``[B, H, P]`` select the same valid pages per
    (sequence, head), in any slot order."""
    big = torch.iinfo(torch.int32).max

    def key(tbl, vld):
        return torch.sort(torch.where(vld, tbl.to(torch.int32), big), dim=-1).values

    return torch.equal(vld_a.sum(-1), vld_b.sum(-1)) and torch.equal(
        key(tbl_a, vld_a), key(tbl_b, vld_b))


def check_scores(s_k, s_p, la, what):
    """Compare kernel and plain block scores ``[B, H, M]`` on the real
    (unpadded) blocks -> (max abs error, max error relative to its (sequence,
    head)'s largest |plain score|)."""
    real = la.pad_mask[None].expand_as(s_p)
    scale = torch.where(real, s_p.abs(), 0.0).amax(-1, keepdim=True)
    d = torch.where(real, (s_k - s_p).abs(), 0.0)
    rel = float((d / scale.clamp(min=1e-30)).max())
    assert rel <= SCORE_RTOL, (f"{what}: score error {rel:.3e} of the head's "
                               f"largest |score| exceeds {SCORE_RTOL}")
    assert torch.equal(s_k[~real], s_p[~real]), f"{what}: padding scores differ"
    return float(d.max()), rel


def compare_centroid_scores(rq, store, la, sparse, seq_len):
    """Staged scoring kernel against its plain version -> {"max_abs_err",
    "max_rel_err", "near_ties", "kernel": scores, "plain": scores,
    "table", "valid"} (the page table selected from the kernel's scores).
    Scores within ``SCORE_RTOL``; the page tables selected from the two
    equal up to near ties, ``page_valid`` exactly."""
    n_kv = la.n_heads
    s_k = ops.centroid_scores(rq, store, la, n_kv)
    s_p = ops.centroid_scores_reference(rq, store, la, n_kv)
    torch.cuda.synchronize()
    err, rel = check_scores(s_k, s_p, la, "centroid_scores")
    sel = dict(seq_len=seq_len, sink_pages=sparse.sink_pages,
               local_pages=sparse.local_pages)
    tbl_k, vld_k = select_page_table(s_k, la, **sel)
    tbl_p, vld_p = select_page_table(s_p, la, **sel)
    assert torch.equal(vld_k, vld_p), "centroid_scores: page_valid differs"
    diff = _selection_diff(s_p, la, sparse.sink_pages, sparse.local_pages, seq_len,
                           tbl_k, tbl_p, vld_k, "centroid_scores")
    return {"max_abs_err": err, "max_rel_err": rel, "near_ties": int(diff.sum()),
            "kernel": s_k, "plain": s_p, "table": tbl_k, "valid": vld_k}


def compare_paged_attention(q, k, v, page_table, page_valid, page_size, seq_len,
                            n_split=None):
    """Paged-attention kernel (``n_split`` slot runs, default its plan)
    against its plain version on one page table -> {"max_abs_err",
    "max_rel_l2", "tol_use", "kernel", "plain"}.  Every output row is
    compared, those of a head with no live token too (both versions give
    the mean V row of its table there, as JAX's kernel does)."""
    args = (q, k, v, page_table, page_valid, page_size, seq_len)
    out_k = ops.paged_attention(*args, **_split_kw(n_split))
    out_p = ops.paged_attention_reference(*args)
    torch.cuda.synchronize()
    keep = torch.ones(out_p.shape[:-1], dtype=torch.bool, device=out_p.device)
    err, rel, use = check_outputs(out_k, out_p, keep, "paged_attention")
    return {"max_abs_err": err, "max_rel_l2": rel, "tol_use": use,
            "kernel": out_k, "plain": out_p}


def prefill_selection(q, rq, k, v, score_store, la, sparse, n_valid, chunk_offset):
    """The plain version's selection for sparse prefill (``extras`` of
    :func:`repro_torch.kernels.ref.sparse_prefill_ref`) and the per-head K."""
    q6, rq6, k_sel, nv, qb0 = ops._prefill_query_blocks(
        q, rq, la, sparse.prefill_block_q, sparse.prefill_topk_scale, n_valid,
        chunk_offset,
    )
    ss = score_store
    rows = ref.dequant_score_rows(ss.codes, ss.scale, ss.zero, ss.bits, ss.symmetric)
    _, _, extra = ref.sparse_prefill_ref(
        q6, rq6, k, v, rows, la, k_sel, nv, qb0, sparse.prefill_block_q,
        sparse.sink_pages, sparse.local_pages, extras=True,
    )
    return extra, k_sel


def check_prefill_ties(diff, extra, k_sel):
    """The blocks selected by one version only (``diff`` ``[B, H, nQB, M]``)
    must each be a scored candidate within ``TIE_RTOL`` of its cell's K-th
    candidate score (``extra``: the plain selection's, ``k_sel`` the
    per-head K) -> the cells holding such a near tie ``[B, H, nQB]``."""
    scores = extra["cand_scores"]                              # [B, H, nQB, M]
    vals = torch.sort(scores, dim=-1, descending=True).values
    kk = k_sel.long()[None, :, None, None].expand(*vals.shape[:-1], 1)
    thr = vals.gather(-1, (kk - 1).clamp(min=0))
    ok = ~diff | (extra["cand"] & _near(scores, thr.expand_as(scores)))
    assert bool(ok.all()), "sparse_prefill: a block selected by one version only is not a near tie"
    return diff.any(-1)


def compare_sparse_prefill(q, rq, k, v, score_store, la, sparse, n_valid,
                           chunk_offset, n_split=None):
    """Prefill kernel (``n_split`` key-tile runs per cell, default its plan)
    against its plain version -> {"max_abs_err", "max_rel_l2", "tol_use",
    "near_ties", "tie_cells"}; ``n_attended`` must match exactly, and the
    selected block sets up to near ties."""
    kw = dict(sink_pages=sparse.sink_pages, local_pages=sparse.local_pages,
              block_q=sparse.prefill_block_q, topk_scale=sparse.prefill_topk_scale,
              n_valid=n_valid, chunk_offset=chunk_offset, return_selected=True)
    out_k, att_k, sel_k = ops.sparse_prefill(q, rq, k, v, score_store, la,
                                             **kw, **_split_kw(n_split))
    out_p, att_p, sel_p = ops.sparse_prefill_reference(q, rq, k, v, score_store,
                                                       la, **kw)
    torch.cuda.synchronize()
    assert torch.equal(att_k, att_p), "sparse_prefill: n_attended differs"
    extra, k_sel = prefill_selection(q, rq, k, v, score_store, la, sparse,
                                     n_valid, chunk_offset)
    diff = sel_k ^ sel_p
    tie_cells = check_prefill_ties(diff, extra, k_sel)         # [B, H, nQB]
    B, Hq, Sq, D = q.shape
    n_kv, bq = k.shape[1], sparse.prefill_block_q
    keep = (~tie_cells).repeat_interleave(bq, dim=-1)[..., :Sq]  # [B, H, Sq]
    keep = keep.repeat_interleave(Hq // n_kv, dim=1)           # [B, Hq, Sq]
    err, rel, use = check_outputs(out_k, out_p, keep, "sparse_prefill")
    return {"max_abs_err": err, "max_rel_l2": rel, "tol_use": use,
            "near_ties": int(diff.sum()), "tie_cells": int(tie_cells.sum())}


def check_pool(got, want, method, what="pool_rank_keys"):
    """Compare kernel and plain rank keys -> (max abs error, max error
    relative to its row's largest |plain|): quest bitwise, mean and
    arkvale within ``POOL_RTOL``."""
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    d = (got - want).abs()
    row = want.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    rel = float((d / row).max())
    if method == "quest":
        assert torch.equal(got, want), f"{what} ({method}): not bitwise equal"
    else:
        assert rel <= POOL_RTOL, (f"{what} ({method}): error {rel:.3e} of "
                                  f"the row's largest magnitude exceeds {POOL_RTOL}")
    return float(d.max()), rel


def compare_pool_rank_keys(keys, block_size, method):
    """Pooling kernel against its plain version -> {"max_abs_err",
    "max_rel_err", "kernel", "plain"}."""
    got = block_centroid.pool_rank_keys(keys, block_size, method)
    want = block_centroid.pool_rank_keys_plain(keys, block_size, method)
    torch.cuda.synchronize()
    err, rel = check_pool(got, want, method)
    return {"max_abs_err": err, "max_rel_err": rel, "kernel": got, "plain": want}


def threshold_selection(scores, thr, count_gt, k_per_head):
    """The set a threshold defines -> ``[B, H, M]`` bool: every score above
    ``thr``, then the first ``K_h - count_gt`` scores equal to it in index
    order (in the kernels' order, where -0.0 ranks below +0.0)."""
    key, t = ref.sortable_key(scores), ref.sortable_key(thr)[..., None]
    tie = key == t
    room = (k_per_head.to(count_gt.dtype)[None, :] - count_gt)[..., None]
    return (key > t) | (tie & (tie.cumsum(-1) <= room))


def stable_topk_selection(scores, k_per_head):
    """The first K_h of a stable descending sort in the kernels' order
    (``lax.top_k``'s set; :func:`repro_torch.core.selection.rank_blocks`'
    order when no score is -0.0)."""
    M = scores.shape[-1]
    idx = torch.sort(ref.sortable_key(scores), dim=-1, descending=True,
                     stable=True).indices
    rank_ok = torch.arange(M, device=scores.device) < k_per_head.to(scores.device)[:, None]
    return torch.zeros_like(scores, dtype=torch.bool).scatter(
        -1, idx, rank_ok.expand_as(idx))


def compare_topk_threshold(scores, k_per_head):
    """Threshold kernel against its plain version -> {"kernel": (thr, cnt),
    "selected": [B, H, M]}; both outputs bitwise equal, and the selected set
    that of a stable descending sort."""
    k = torch.as_tensor(k_per_head, dtype=torch.int32, device=scores.device)
    thr_k, cnt_k = topk_threshold.topk_threshold(scores, k)
    thr_p, cnt_p = topk_threshold.topk_threshold_plain(scores, k)
    torch.cuda.synchronize()
    assert torch.equal(thr_k, thr_p), "topk_threshold: thresholds differ"
    assert torch.equal(cnt_k, cnt_p), "topk_threshold: counts differ"
    sel = threshold_selection(scores, thr_k, cnt_k, k)
    assert torch.equal(sel, stable_topk_selection(scores, k)), \
        "topk_threshold: the threshold's set is not the stable top-K"
    return {"kernel": (thr_k, cnt_k), "selected": sel}


def compare_flash_attention(q, k, v, causal, q_offset=0, k_len=None):
    """Dense flash kernel (queries at ``q_offset`` over the keys
    ``[0, k_len)``) against its plain version -> {"max_abs_err",
    "max_rel_l2", "tol_use", "kernel", "plain"}; every row compared."""
    out_k = ops.flash_attention(q, k, v, causal, q_offset, k_len)
    out_p = ops.flash_attention_reference(q, k, v, causal, q_offset, k_len)
    torch.cuda.synchronize()
    return dict(hold_flash_attention(out_k, out_p), kernel=out_k, plain=out_p)


def hold_flash_attention(out_k, out_p):
    """Hold one dense flash call's output against the plain version's on the
    same inputs: every row under the bf16 rule -> {"max_abs_err",
    "max_rel_l2", "tol_use"}; raises ``AssertionError`` otherwise."""
    keep = torch.ones(out_p.shape[:-1], dtype=torch.bool, device=out_p.device)
    err, rel, use = check_outputs(out_k, out_p, keep, "flash_attention")
    return {"max_abs_err": err, "max_rel_l2": rel, "tol_use": use}
