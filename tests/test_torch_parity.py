"""The kernel-vs-plain comparison of :mod:`repro_torch.kernels.parity`, on
the CPU.

Here the wrappers run their plain versions, so the "kernel" and the plain
side agree exactly and the comparison must pass.  Outputs or selections
that a faulty kernel would give (a page left out, outputs off by 2%, a
forced block dropped, a block score moved past its tolerance) are
substituted for the kernel's and must fail it.
"""
import pytest
import torch

from repro_torch.backends.base import CentroidStore
from repro_torch.backends.store import build_score_rows, build_store_codes
from repro_torch.config import SparseConfig
from repro_torch.core.centroids import rank_query
from repro_torch.core.quantization import store_bits
from repro_torch.core.ragged import layout_for
from repro_torch.core.sparse_attention import paged_attention_reference
from repro_torch.core.stacked import as_arrays
from repro_torch.kernels import ops, parity

B, N_KV, G, S, D, PS, BUDGET = 2, 4, 2, 512, 32, 16, 128
BLOCKS = (16, 32, 64, 32)


@pytest.fixture(autouse=True)
def _no_cuda_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def _inputs(seed, q_shape):
    sparse = SparseConfig(token_budget=BUDGET, quant="int4_asym",
                          sink_pages=1, local_pages=2)
    la = as_arrays(layout_for(BLOCKS, S, PS, BUDGET), "cpu")
    gen = torch.Generator().manual_seed(seed)
    shape = (B, N_KV, S // PS, PS, D)
    k = torch.randn(shape, generator=gen).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen).to(torch.bfloat16)
    q = (torch.randn(q_shape, generator=gen) * parity.QSCALE).to(torch.bfloat16)
    return sparse, la, q, k, v


def _decode_case():
    sparse, la, q, k, v = _inputs(0, (B, N_KV * G, D))
    store = build_store_codes(k, la, sparse)
    rq = rank_query(q, sparse.centroid_method, D)
    seq_len = torch.tensor([S, 301], dtype=torch.int32)
    return q, rq, k, v, store, la, sparse, seq_len


def _prefill_case():
    sparse, la, q, k, v = _inputs(1, (B, N_KV * G, 192, D))
    codes, sc, ze = build_score_rows(k, la, sparse)
    ss = CentroidStore(codes, sc, ze, store_bits(sparse.quant), False)
    rq = rank_query(q, sparse.centroid_method, D)
    n_valid = torch.tensor([448, 300], dtype=torch.int32)
    return q, rq, k, v, ss, la, sparse, n_valid, 256


def test_fused_decode_comparison_passes_on_equal_outputs():
    res = parity.compare_fused_decode(*_decode_case())
    assert res["max_abs_err"] == 0.0 and res["near_ties"] == 0


def test_sparse_prefill_comparison_passes_on_equal_outputs():
    res = parity.compare_sparse_prefill(*_prefill_case())
    assert res["max_abs_err"] == 0.0 and res["near_ties"] == 0


def _drop_middle_page(q, k, v, tbl, vld, seq_len):
    mid = (vld.cumsum(-1) == vld.sum(-1, keepdim=True) // 2 + 1) & vld
    return paged_attention_reference(q, k, v, tbl, vld & ~mid, PS, seq_len)


@pytest.mark.parametrize("fault", ["page-left-out", "outputs-off-2pct"])
def test_fused_decode_comparison_catches_faulty_outputs(monkeypatch, fault):
    plain = ops.fused_decode

    def faulty(q, rq, k, v, store, la, sink, local, seq_len):
        out, tbl, vld = plain(q, rq, k, v, store, la, sink, local, seq_len)
        if fault == "page-left-out":
            out = _drop_middle_page(q, k, v, tbl, vld, seq_len)
        else:
            out = (out.float() * 1.02).to(out.dtype)
        return out, tbl, vld

    monkeypatch.setattr(ops, "fused_decode", faulty)
    with pytest.raises(AssertionError, match="fused_decode: .*error"):
        parity.compare_fused_decode(*_decode_case())


@pytest.mark.parametrize("fault", ["forced-block-dropped", "outputs-off-2pct"])
def test_sparse_prefill_comparison_catches_faulty_kernel(monkeypatch, fault):
    plain = ops.sparse_prefill

    def faulty(*a, **kw):
        out, n_att, sel = plain(*a, **kw)
        if fault == "forced-block-dropped":
            sel = sel.clone()
            sel[0, 0, 0, 0] = False          # the sink block of a live cell
        else:
            out = (out.float() * 1.02).to(out.dtype)
        return out, n_att, sel

    monkeypatch.setattr(ops, "sparse_prefill", faulty)
    match = "not a near tie" if fault == "forced-block-dropped" else "error"
    with pytest.raises(AssertionError, match=match):
        parity.compare_sparse_prefill(*_prefill_case())


def test_sparse_prefill_returns_its_selection():
    q, rq, k, v, ss, la, sparse, n_valid, off = _prefill_case()
    kw = dict(sink_pages=sparse.sink_pages, local_pages=sparse.local_pages,
              block_q=sparse.prefill_block_q, n_valid=n_valid, chunk_offset=off)
    out, n_att = ops.sparse_prefill(q, rq, k, v, ss, la, **kw)
    out_s, n_att_s, sel = ops.sparse_prefill(q, rq, k, v, ss, la,
                                             return_selected=True, **kw)
    assert sel.dtype == torch.bool
    assert sel.shape == (*n_att.shape, la.max_blocks)
    assert torch.equal(out, out_s) and torch.equal(n_att, n_att_s)
    assert torch.equal(sel.sum(-1).to(torch.int32), n_att)
    assert bool(sel[..., 0][n_att > 0].all())    # the sink block is forced


# -- staged decode: scoring and paged attention --------------------------------


def _staged_case():
    q, rq, k, v, store, la, sparse, seq_len = _decode_case()
    return rq, store, la, sparse, seq_len


def test_centroid_scores_comparison_passes_and_matches_fused_pages():
    res = parity.compare_centroid_scores(*_staged_case())
    assert res["max_abs_err"] == 0.0 and res["near_ties"] == 0
    q, rq, k, v, store, la, sparse, seq_len = _decode_case()
    _, f_tbl, f_vld = ops.fused_decode(q, rq, k, v, store, la, sparse.sink_pages,
                                       sparse.local_pages, seq_len)
    assert parity.page_sets_equal(res["table"], res["valid"], f_tbl, f_vld)
    assert not parity.page_sets_equal(res["table"], res["valid"] & ~_middle(res["valid"]),
                                      f_tbl, f_vld)


def test_centroid_scores_comparison_catches_a_moved_score(monkeypatch):
    plain = ops.centroid_scores

    def faulty(rq, store, la, n_kv):
        s = plain(rq, store, la, n_kv).clone()
        top = s[0, 1].abs().max()
        s[0, 1, 3] += 10 * parity.SCORE_RTOL * top    # one row, 10x the tolerance
        return s

    monkeypatch.setattr(ops, "centroid_scores", faulty)
    with pytest.raises(AssertionError, match="centroid_scores: score error"):
        parity.compare_centroid_scores(*_staged_case())


def _middle(vld):
    return (vld.cumsum(-1) == vld.sum(-1, keepdim=True) // 2 + 1) & vld


def _paged_case():
    q, rq, k, v, store, la, sparse, seq_len = _decode_case()
    res = parity.compare_centroid_scores(rq, store, la, sparse, seq_len)
    return q, k, v, res["table"], res["valid"], PS, seq_len


def test_paged_attention_comparison_passes_on_equal_outputs():
    res = parity.compare_paged_attention(*_paged_case())
    assert res["max_abs_err"] == 0.0


@pytest.mark.parametrize("fault", ["page-left-out", "outputs-off-2pct"])
def test_paged_attention_comparison_catches_faulty_outputs(monkeypatch, fault):
    plain = ops.paged_attention

    def faulty(q, k, v, tbl, vld, page_size, seq_len):
        if fault == "page-left-out":
            return plain(q, k, v, tbl, vld & ~_middle(vld), page_size, seq_len)
        out = plain(q, k, v, tbl, vld, page_size, seq_len)
        return (out.float() * 1.02).to(out.dtype)

    monkeypatch.setattr(ops, "paged_attention", faulty)
    with pytest.raises(AssertionError, match="paged_attention: .*error"):
        parity.compare_paged_attention(*_paged_case())


# -- pooling, top-K threshold, dense flash attention -----------------------------


@pytest.mark.parametrize("method", ["mean", "quest", "arkvale"])
def test_pool_rank_keys_comparison_passes_and_catches_a_moved_key(monkeypatch, method):
    from repro_torch.kernels import block_centroid

    keys = torch.randn((2, 3, 256, D), generator=torch.Generator().manual_seed(3))
    res = parity.compare_pool_rank_keys(keys, 32, method)
    assert res["max_abs_err"] == 0.0
    plain = block_centroid.pool_rank_keys

    def faulty(keys, bs, method):
        out = plain(keys, bs, method).clone()
        out[1, 2, 3, 0] += 10 * parity.POOL_RTOL * out[1, 2, 3].abs().max()
        return out

    monkeypatch.setattr(block_centroid, "pool_rank_keys", faulty)
    with pytest.raises(AssertionError, match="pool_rank_keys"):
        parity.compare_pool_rank_keys(keys, 32, method)


def _tied_scores():
    gen = torch.Generator().manual_seed(4)
    s = torch.randint(-3, 4, (2, 4, 64), generator=gen).float()
    s[:, :, ::7] = float("-inf")
    s[:, :, 5::11] = float("inf")
    s[:, 1, 40:] = -1e30
    return s


def test_topk_threshold_comparison_passes_on_ties_and_infs():
    s, k = _tied_scores(), torch.tensor([1, 9, 33, 64], dtype=torch.int32)
    res = parity.compare_topk_threshold(s, k)
    assert (res["selected"].sum(-1) == k).all()


def test_topk_threshold_comparison_catches_a_wrong_count(monkeypatch):
    from repro_torch.kernels import topk_threshold as tk

    plain = tk.topk_threshold

    def faulty(scores, k):
        thr, cnt = plain(scores, k)
        return thr, cnt + 1

    monkeypatch.setattr(tk, "topk_threshold", faulty)
    with pytest.raises(AssertionError, match="counts differ"):
        parity.compare_topk_threshold(_tied_scores(), [3, 3, 3, 3])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_comparison_passes_and_catches_2pct(monkeypatch, causal):
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((1, h, 256, D), generator=gen).to(torch.bfloat16)
               for h in (4, 2, 2))
    res = parity.compare_flash_attention(q, k, v, causal)
    assert res["max_abs_err"] == 0.0
    plain = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: (plain(*a, **kw).float() * 1.02).to(torch.bfloat16))
    with pytest.raises(AssertionError, match="flash_attention"):
        parity.compare_flash_attention(q, k, v, causal)
