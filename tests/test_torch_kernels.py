"""Parity of the PyTorch port's store builders and kernel plain versions
with the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both.  The JAX side runs
its plain reference path (the staged decode: reference scores ->
``select_page_table`` -> ``paged_attention_reference``; and
``ops.sparse_prefill_reference``).  The port runs its kernels' wrappers on
CPU tensors, which take the plain versions.

- store bytes (codes, scale, zero) are identical, asymmetric and symmetric;
- fused decode: page_valid identical, and the valid pages of each
  (sequence, head) identical as a set (the port lists the selected blocks
  in ascending order, the staged JAX path in score order), outputs within
  1e-5 (f32);
- sparse prefill: n_attended identical, outputs within 1e-5 (f32);
- topk_threshold (against JAX's kernel in interpret mode and its plain
  reference): thresholds and counts identical, ties and +-inf included;
- flash_attention (against JAX's kernel in interpret mode): f32 outputs
  within 1e-5, bf16 outputs within one bf16 rounding step (2^-7 relative)
  plus 1e-4.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import get_backend as jax_backend
from repro.backends import store as jstore
from repro.config import SparseConfig as JSparse
from repro.core.centroids import rank_query as j_rank_query
from repro.core.ragged import layout_for as j_layout_for
from repro.core.selection import select_page_table as j_select
from repro.core.sparse_attention import paged_attention_reference as j_paged
from repro.core.stacked import as_arrays as j_as_arrays
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.topk_threshold import topk_threshold as j_topk

from repro_torch.backends import CentroidStore, store as tstore
from repro_torch.config import SparseConfig as TSparse
from repro_torch.core.centroids import rank_query as t_rank_query
from repro_torch.core.quantization import store_bits, store_symmetric
from repro_torch.core.ragged import layout_for as t_layout_for
from repro_torch.core.stacked import as_arrays as t_as_arrays
from repro_torch.kernels import fused_decode as tfd
from repro_torch.kernels import topk_threshold as ttk
from repro_torch.kernels import ops as tops

B, N_KV, G, S, D, PS = 2, 4, 2, 512, 16, 16
LAYOUTS = {
    "nonuniform": (16, 32, 64, 32),
    "mixed": (64, 16, 16, 32),
    "uniform": (32, 32, 32, 32),
}
QUANTS = ["none", "int8_asym", "int4_asym"]
STORE_QUANTS = QUANTS + ["int8_sym", "int4_sym"]
BUDGET = 128


def _cfgs(**kw):
    return JSparse(token_budget=BUDGET, **kw), TSparse(token_budget=BUDGET, **kw)


def _layouts(blocks):
    return (
        j_as_arrays(j_layout_for(blocks, S, PS, BUDGET)),
        t_as_arrays(t_layout_for(blocks, S, PS, BUDGET)),
    )


def _kv(seed, shape=(B, N_KV, S // PS, PS, D)):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal(shape).astype(np.float32),
        rng.standard_normal(shape).astype(np.float32),
    )


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_bytes(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


# -- store builders --------------------------------------------------------


@pytest.mark.parametrize("quant", STORE_QUANTS)
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
def test_store_builders_bytes_identical(quant, blocks):
    jcfg, tcfg = _cfgs(quant=quant)
    jla, tla = _layouts(blocks)
    k, _ = _kv(1)
    offs = jnp.asarray(jla.row_offsets)
    js = jstore.build_store_codes(jnp.asarray(k), jla, offs, jcfg, quant)
    ts = tstore.build_store_codes(_t(k), tla, tcfg, quant)
    for a, b in ((js.codes, ts.codes), (js.scale, ts.scale), (js.zero, ts.zero)):
        _same_bytes(a, b)
    jr = jstore.build_score_rows(jnp.asarray(k), jla, offs, jcfg, quant)
    tr = tstore.build_score_rows(_t(k), tla, tcfg, quant)
    for a, b in zip(jr, tr):
        _same_bytes(a, b)


@pytest.mark.parametrize("quant", STORE_QUANTS)
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
def test_store_refresh_bytes_identical(quant, blocks):
    """refresh_score_rows over chunks (including a window clamped at the end
    of the cache) and refresh_tail_codes at ragged positions."""
    jcfg, tcfg = _cfgs(quant=quant)
    jla, tla = _layouts(blocks)
    k0, k1 = _kv(2)
    offs = jnp.asarray(jla.row_offsets)
    jc, js_, jz = jstore.build_score_rows(jnp.asarray(k0), jla, offs, jcfg, quant)
    tc, ts_, tz = tstore.build_score_rows(_t(k0), tla, tcfg, quant)
    bits, sym = store_bits(quant), store_symmetric(quant)
    for start, end in ((0, 128), (128, 200), (192, 448), (448, 512)):
        window = min(-(-(end - start + 128) // 64) * 64, S)
        jc, js_, jz = jstore.refresh_score_rows(
            jc, js_, jz, jnp.asarray(k1), jla, offs, start, end, jcfg, window,
            bits=bits, symmetric=sym,
        )
        tstore.refresh_score_rows(
            tc, ts_, tz, _t(k1), tla, start, end, tcfg, window, bits, sym
        )
    for a, b in ((jc, tc), (js_, ts_), (jz, tz)):
        _same_bytes(a, b)

    jst = jstore.build_store_codes(jnp.asarray(k0), jla, offs, jcfg, quant)
    tst = tstore.build_store_codes(_t(k0), tla, tcfg, quant)
    for seq in ((0, 511), (63, 64), (300, 17)):
        sl = np.asarray(seq, np.int32)
        jcodes = jstore.refresh_tail_codes(
            jst, jnp.asarray(k1), jla, offs, jnp.asarray(sl), jcfg
        )
        jst = dataclasses.replace(jst, codes=jcodes)
        tstore.refresh_tail_codes(tst, _t(k1), tla, _t(sl), tcfg)
    _same_bytes(jst.codes, tst.codes)


# -- fused decode ------------------------------------------------------------


def _page_sets(table, valid):
    t, m = np.asarray(table), np.asarray(valid)
    return {
        (b, h): sorted(t[b, h][m[b, h]].tolist())
        for b in range(t.shape[0]) for h in range(t.shape[1])
    }


def _decode_both(blocks, quant, seq, sink, local, seed):
    jcfg, tcfg = _cfgs(quant=quant, sink_pages=sink, local_pages=local)
    jla, tla = _layouts(blocks)
    k, v = _kv(seed)
    rng = np.random.default_rng(seed + 100)
    q = rng.standard_normal((B, N_KV * G, D)).astype(np.float32)
    sl = np.asarray(seq, np.int32)
    offs = jnp.asarray(jla.row_offsets)
    jst = jstore.build_store_codes(jnp.asarray(k), jla, offs, jcfg, quant)

    ref = jax_backend("reference")
    rq = j_rank_query(jnp.asarray(q), jcfg.centroid_method, D)
    scores = ref.scores(rq, jst, jla, N_KV)
    tbl, vld = j_select(scores, jla, seq_len=jnp.asarray(sl),
                        sink_pages=sink, local_pages=local)
    out = j_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tbl, vld,
                  PS, jnp.asarray(sl))

    tst = CentroidStore(_t(jst.codes), _t(jst.scale), _t(jst.zero),
                        jst.bits, jst.symmetric)
    trq = t_rank_query(_t(q), tcfg.centroid_method, D)
    t_out, t_tbl, t_vld = tops.fused_decode(
        _t(q), trq, _t(k), _t(v), tst, tla, sink, local, _t(sl)
    )
    return (out, tbl, vld), (t_out, t_tbl, t_vld)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
@pytest.mark.parametrize("sink,local", [(0, 0), (2, 8), (1, 4)])
def test_fused_decode_plain_matches_jax_staged(quant, blocks, sink, local):
    calls = tfd.plain_calls
    (out, tbl, vld), (t_out, t_tbl, t_vld) = _decode_both(
        blocks, quant, (S, 301), sink, local, seed=3
    )
    assert tfd.plain_calls == calls + 1 and tfd.launches == 0
    np.testing.assert_array_equal(np.asarray(vld), t_vld.numpy())
    assert _page_sets(tbl, vld) == _page_sets(t_tbl, t_vld)
    np.testing.assert_allclose(np.asarray(out), t_out.numpy(), atol=1e-5)


@pytest.mark.parametrize("seq", [(1, 17), (31, 100), (512, 129)],
                         ids=["edge", "tiny", "ragged"])
def test_fused_decode_plain_ragged_seq_len(seq):
    (out, tbl, vld), (t_out, t_tbl, t_vld) = _decode_both(
        LAYOUTS["nonuniform"], "int4_asym", seq, 1, 4, seed=5
    )
    np.testing.assert_array_equal(np.asarray(vld), t_vld.numpy())
    assert _page_sets(tbl, vld) == _page_sets(t_tbl, t_vld)
    np.testing.assert_allclose(np.asarray(out), t_out.numpy(), atol=1e-5)


# -- sparse prefill ----------------------------------------------------------


def _prefill_both(blocks, quant, sink, local, chunk_offset, sq, n_valid,
                  seed, scale=1.0):
    kw = dict(quant=quant, sink_pages=sink, local_pages=local,
              prefill_block_q=64, prefill_topk_scale=scale)
    jcfg, tcfg = _cfgs(**kw)
    jla, tla = _layouts(blocks)
    k, v = _kv(seed)
    rng = np.random.default_rng(seed + 200)
    q = rng.standard_normal((B, N_KV * G, sq, D)).astype(np.float32)
    offs = jnp.asarray(jla.row_offsets)
    codes, sc, ze = jstore.build_score_rows(jnp.asarray(k), jla, offs, jcfg, quant)
    bits = 0 if quant == "none" else int(quant[3])
    jss = jax_backend("reference").prefill_score_rows(
        jnp.asarray(k), jla, offs, jcfg, quant
    )
    nv = np.asarray(n_valid, np.int32)
    rq = j_rank_query(jnp.asarray(q), jcfg.centroid_method, D)
    out, n_att = jops.sparse_prefill_reference(
        jnp.asarray(q), rq, jnp.asarray(k), jnp.asarray(v), jss, jla,
        sink_pages=sink, local_pages=local, block_q=64, topk_scale=scale,
        n_valid=jnp.asarray(nv), chunk_offset=chunk_offset,
    )
    tss = CentroidStore(_t(codes), _t(sc), _t(ze), bits, False)
    trq = t_rank_query(_t(q), tcfg.centroid_method, D)
    t_out, t_att = tops.sparse_prefill(
        _t(q), trq, _t(k), _t(v), tss, tla, sink_pages=sink,
        local_pages=local, block_q=64, topk_scale=scale,
        n_valid=_t(nv), chunk_offset=chunk_offset,
    )
    return (out, n_att), (t_out, t_att)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
@pytest.mark.parametrize("sink,local", [(0, 0), (2, 8), (1, 4)])
def test_sparse_prefill_plain_matches_jax(quant, blocks, sink, local):
    (out, n_att), (t_out, t_att) = _prefill_both(
        blocks, quant, sink, local, 0, S, (S, 400), seed=11
    )
    np.testing.assert_array_equal(np.asarray(n_att), t_att.numpy())
    np.testing.assert_allclose(np.asarray(out), t_out.numpy(), atol=1e-5)


@pytest.mark.parametrize(
    "chunk_offset,sq,n_valid",
    [(256, 192, (448, 300)), (384, 128, (512, 385)), (128, 256, (384, 200))],
    ids=["dead-tail", "last-chunk", "mostly-dead"],
)
def test_sparse_prefill_plain_chunked_dead_blocks(chunk_offset, sq, n_valid):
    """Later chunks (qb0 > 0) with trailing query blocks past n_valid."""
    (out, n_att), (t_out, t_att) = _prefill_both(
        LAYOUTS["nonuniform"], "int4_asym", 1, 4, chunk_offset, sq, n_valid,
        seed=13, scale=1.5,
    )
    np.testing.assert_array_equal(np.asarray(n_att), t_att.numpy())
    assert (t_att.numpy() == 0).any()          # a dead query block attends nothing
    np.testing.assert_allclose(np.asarray(out), t_out.numpy(), atol=1e-5)


# -- topk threshold ----------------------------------------------------------


def _same_threshold(scores, ks):
    thr, cnt = j_topk(jnp.asarray(scores), tuple(ks), interpret=True)
    rthr, rcnt = jref.topk_threshold_ref(jnp.asarray(scores), ks)
    t_thr, t_cnt = ttk.topk_threshold(_t(scores), list(ks))
    for a in (thr, rthr):
        _same_bytes(a, t_thr)
    for a in (cnt, rcnt):
        _same_bytes(a, t_cnt)
    assert t_thr.dtype == torch.float32 and t_cnt.dtype == torch.int32
    return t_thr, t_cnt


@pytest.mark.parametrize("M", [128, 512, 2048])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_threshold_plain_matches_jax(M, seed):
    rng = np.random.default_rng(seed)
    scores = (rng.standard_normal((2, 4, M)) * 10).astype(np.float32)
    _same_threshold(scores, [int(x) for x in rng.integers(1, M, 4)])


def test_topk_threshold_ties_and_infs():
    row = [1.0, 2.0, 2.0, 2.0, -1e30, 0.5, -2.0, 2.0,
           np.inf, -np.inf, 2.0, -np.inf, 0.5, np.inf, 1e30, -3.0]
    scores = np.asarray([[row, row[::-1]]], np.float32)
    for k in (1, 2, 3, 5, 8, 12, 15, 16):
        thr, cnt = _same_threshold(scores, [k, k])
        # {score > thr} plus the first k - count ties in index order is the
        # stable descending sort's top k
        s = _t(scores)
        order = torch.sort(s, dim=-1, descending=True, stable=True).indices[..., :k]
        top = torch.zeros_like(s, dtype=torch.bool).scatter(-1, order, True)
        ties = (s == thr[..., None]).cumsum(-1) <= (k - cnt)[..., None]
        assert torch.equal(top, (s > thr[..., None]) | ((s == thr[..., None]) & ties))


def test_topk_threshold_signed_zeros_rank_as_the_tpu_kernel():
    """The sortable encoding ranks -0.0 just below +0.0, in JAX's kernel and
    in the port's plain version alike."""
    scores = np.asarray([[[0.0, -0.0, 1.0, -0.0, 0.0, -1.0, -0.0, 0.0]]], np.float32)
    for k in range(1, 9):
        thr, cnt = j_topk(jnp.asarray(scores), (k,), interpret=True)
        t_thr, t_cnt = ttk.topk_threshold(_t(scores), [k])
        _same_bytes(thr, t_thr)
        _same_bytes(cnt, t_cnt)
        assert np.signbit(t_thr.numpy()[0, 0]) == (k >= 5)     # -0.0 from k = 5
        if 5 <= k <= 7:
            assert int(t_cnt[0, 0]) == 4                       # 1.0 and three +0.0


def test_ops_topk_threshold_takes_k_from_the_layout():
    blocks = LAYOUTS["nonuniform"]
    jla, tla = _layouts(blocks)
    scores = np.random.default_rng(3).standard_normal((B, N_KV, jla.max_blocks))
    scores = scores.astype(np.float32)
    jt, jc = jops.topk_threshold(jnp.asarray(scores), j_layout_for(blocks, S, PS, BUDGET),
                                 interpret=True)
    tt, tc = tops.topk_threshold(_t(scores), tla)
    _same_bytes(jt, tt)
    _same_bytes(jc, tc)
    with pytest.raises(ValueError, match="must hold"):
        ttk.topk_threshold(_t(scores), [0] * N_KV)


# -- flash attention ---------------------------------------------------------


@pytest.mark.parametrize(
    "b,hq,hkv,s,d,causal",
    [(1, 2, 1, 256, 64, True), (2, 4, 2, 384, 32, True), (1, 8, 2, 256, 64, True),
     (1, 4, 4, 256, 32, False), (2, 6, 2, 128, 64, False)],
)
def test_flash_attention_plain_matches_jax(b, hq, hkv, s, d, causal):
    rng = np.random.default_rng(hq * s + d)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                   interpret=True)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)), atol=1e-5)


def test_flash_attention_plain_bf16():
    rng = np.random.default_rng(5)
    q, k, v = (jnp.asarray(rng.standard_normal((1, h, 256, 64)), jnp.bfloat16)
               for h in (4, 2, 2))
    want = np.asarray(j_flash(q, k, v, causal=True, interpret=True), np.float32)
    to_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    got = tops.flash_attention(to_t(q), to_t(k), to_t(v), causal=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= 1e-4 + 2.0 ** -7 * np.abs(want)).all()
