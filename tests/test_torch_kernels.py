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
- sparse prefill: n_attended identical, outputs within 1e-5 (f32).
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

from repro_torch.backends import CentroidStore, store as tstore
from repro_torch.config import SparseConfig as TSparse
from repro_torch.core.centroids import rank_query as t_rank_query
from repro_torch.core.quantization import store_bits, store_symmetric
from repro_torch.core.ragged import layout_for as t_layout_for
from repro_torch.core.stacked import as_arrays as t_as_arrays
from repro_torch.kernels import fused_decode as tfd
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
