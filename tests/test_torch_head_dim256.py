"""The attention kernels' plain versions at the dense family's new shapes
against the JAX package's kernels in interpret mode, on the CPU.

gemma-7b attends with head_dim 256 (rank keys of Dp 512 under quest), and
qwen3-32b's GQA group of 8 makes a sparse-prefill query block of 64
positions 512 query rows.  Inputs are made with numpy from a seed (values
rounded to bf16 first) and fed to both; the port's wrappers get CPU
tensors, so they run their plain versions.

- ``centroid_scores_quantized`` at Dp 512: scores within ``SCORE_RTOL`` of
  each (sequence, head)'s largest |score| (the two sum 512 products in
  other orders), the page tables selected from them identical;
- ``fused_decode`` at D 256 (group 1) and at group 8 (D 128): page_valid
  identical, the valid pages of each (sequence, head) identical, outputs
  within 1e-5 (f32);
- ``paged_attention`` at D 256: f32 within 1e-5, bf16 within one bf16
  rounding step (:mod:`repro_torch.kernels.parity`);
- ``sparse_prefill`` at D 256 and at g * BQ 512: n_attended identical,
  outputs within 1e-5 (f32);
- ``flash_attention`` at D 256: S x S against JAX's kernel (causal and
  not), and with a query offset and a key length against JAX's dense
  prefill chunk, within 1e-5 (f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import get_backend as jax_backend
from repro.backends import store as jstore
from repro.config import SparseConfig as JSparse
from repro.core.centroids import padded_rank_key_width as j_width
from repro.core.centroids import rank_query as j_rank_query
from repro.core.ragged import layout_for as j_layout_for
from repro.core.selection import select_page_table as j_select
from repro.core.stacked import as_arrays as j_as_arrays
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as j_flash

from repro_torch.backends import CentroidStore
from repro_torch.config import SparseConfig as TSparse
from repro_torch.core.centroids import padded_rank_key_width as t_width
from repro_torch.core.centroids import rank_query as t_rank_query
from repro_torch.core.ragged import layout_for as t_layout_for
from repro_torch.core.selection import select_page_table as t_select
from repro_torch.core.stacked import as_arrays as t_as_arrays
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import parity

B, S, PS, BUDGET, BQ = 2, 512, 16, 128, 64
BLOCKS = (16, 32)
#: f32 scores: |port - JAX| <= SCORE_RTOL * max |score| of the (sequence,
#: head); the two sum Dp products in different orders
SCORE_RTOL = 1e-5
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU ops on one thread (the suite runs in parallel
    workers; torch's default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_rounded(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _case(d, g, quant, seed):
    kw = dict(token_budget=BUDGET, quant=quant, sink_pages=1, local_pages=4,
              prefill_block_q=BQ)
    jcfg, tcfg = JSparse(**kw), TSparse(**kw)
    jla = j_as_arrays(j_layout_for(BLOCKS, S, PS, BUDGET))
    tla = t_as_arrays(t_layout_for(BLOCKS, S, PS, BUDGET))
    rng = np.random.default_rng(seed)
    shape = (B, len(BLOCKS), S // PS, PS, d)
    k, v = _bf16_rounded(rng, shape), _bf16_rounded(rng, shape)
    return jcfg, tcfg, jla, tla, k, v, rng


def test_rank_key_width_at_head_dim_256():
    """quest rank keys at head_dim 256 are 512 wide in both packages."""
    for method in ("mean", "quest", "arkvale"):
        assert t_width(256, method) == j_width(256, method)
    assert t_width(256, "quest") == 512


@pytest.mark.parametrize("quant", ["int4_asym", "int8_asym"])
def test_centroid_scores_at_dp512_match_jax_kernel(quant):
    jcfg, tcfg, jla, tla, k, v, rng = _case(256, 1, quant, seed=1)
    q = rng.standard_normal((B, len(BLOCKS), 256)).astype(np.float32)
    jst = jstore.build_store_codes(jnp.asarray(k), jla, jnp.asarray(jla.row_offsets),
                                   jcfg, quant)
    tst = CentroidStore(_t(jst.codes), _t(jst.scale), _t(jst.zero), jst.bits,
                        jst.symmetric)
    rq = j_rank_query(jnp.asarray(q), jcfg.centroid_method, 256)
    assert rq.shape[-1] == 512
    want = np.asarray(jops.centroid_scores(rq, jst, jla, len(BLOCKS), interpret=True))
    got = tops.centroid_scores(t_rank_query(_t(q), tcfg.centroid_method, 256), tst,
                               tla, len(BLOCKS)).numpy()
    pad = np.broadcast_to(np.asarray(jla.pad_mask)[None], want.shape)
    np.testing.assert_array_equal(want[~pad], got[~pad])
    scale = np.abs(np.where(pad, want, 0.0)).max(-1, keepdims=True)
    err = np.abs(np.where(pad, want - got, 0.0))
    assert (err <= SCORE_RTOL * scale).all(), float((err / scale).max())
    sl = np.asarray((S, 301), np.int32)
    j_tbl, j_vld = j_select(jnp.asarray(want), jla, seq_len=jnp.asarray(sl))
    t_tbl, t_vld = t_select(_t(got), tla, _t(sl))
    np.testing.assert_array_equal(np.asarray(j_tbl), t_tbl.numpy())
    np.testing.assert_array_equal(np.asarray(j_vld), t_vld.numpy())


@pytest.mark.parametrize("d,g", [(256, 1), (256, 2), (128, 8)],
                         ids=["d256-g1", "d256-g2", "d128-g8"])
def test_fused_decode_matches_jax_kernel(d, g):
    quant = "int4_asym"
    jcfg, tcfg, jla, tla, k, v, rng = _case(d, g, quant, seed=d + g)
    q = _bf16_rounded(rng, (B, len(BLOCKS) * g, d), parity.QSCALE)
    sl = np.asarray((S, 301), np.int32)
    jst = jstore.build_store_codes(jnp.asarray(k), jla, jnp.asarray(jla.row_offsets),
                                   jcfg, quant)
    rq = j_rank_query(jnp.asarray(q), jcfg.centroid_method, d)
    want, jtbl, jvld = jops.fused_decode(jnp.asarray(q), rq, jnp.asarray(k),
                                         jnp.asarray(v), jst, jla, 1, 4, jnp.asarray(sl),
                                         interpret=True)
    tst = CentroidStore(_t(jst.codes), _t(jst.scale), _t(jst.zero), jst.bits,
                        jst.symmetric)
    tq = _t(q)
    out, tbl, vld = tops.fused_decode(tq, t_rank_query(tq, tcfg.centroid_method, d),
                                      _t(k), _t(v), tst, tla, 1, 4, _t(sl))
    np.testing.assert_array_equal(np.asarray(jvld), vld.numpy())
    jv = np.asarray(jvld)
    for b in range(B):
        for h in range(len(BLOCKS)):
            assert (sorted(np.asarray(jtbl)[b, h][jv[b, h]].tolist())
                    == sorted(tbl.numpy()[b, h][jv[b, h]].tolist()))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_at_head_dim_256_matches_jax_kernel(dtype):
    d, g = 256, 1
    _, _, _, tla, k, v, rng = _case(d, g, "int4_asym", seed=7)
    q = _bf16_rounded(rng, (B, len(BLOCKS) * g, d), parity.QSCALE)
    scores = rng.standard_normal((B, len(BLOCKS), tla.max_blocks)).astype(np.float32)
    sl = np.asarray((S - 5, 100), np.int32)
    tbl, vld = t_select(_t(scores), tla, _t(sl))
    vld = vld & _t(rng.random(vld.shape) > 0.25)
    vld[..., 0] = True
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jops.paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(tbl.numpy()), jnp.asarray(vld.numpy()), PS, jnp.asarray(sl),
        interpret=True)
    want = _t(want.astype(jnp.float32))
    got = tops.paged_attention(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt), tbl, vld,
                               PS, _t(sl))
    assert got.dtype == tdt and got.shape == (B, len(BLOCKS) * g, d)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    else:
        keep = torch.ones(got.shape[:-1], dtype=torch.bool)
        parity.check_outputs(got, want, keep, "paged_attention")


@pytest.mark.parametrize("d,g,off,sq,n_valid", [
    (256, 1, 256, 256, (512, 377)), (256, 1, 0, 192, (192, 70)),
    (128, 8, 256, 128, (384, 300)),
], ids=["d256-later-chunk", "d256-first-chunk", "d128-g8-rows512"])
def test_sparse_prefill_matches_jax_kernel(d, g, off, sq, n_valid):
    quant = "int4_asym"
    jcfg, tcfg, jla, tla, k, v, rng = _case(d, g, quant, seed=off + sq + d)
    q = _bf16_rounded(rng, (B, len(BLOCKS) * g, sq, d), parity.QSCALE)
    nv = np.asarray(n_valid, np.int32)
    offs = jnp.asarray(jla.row_offsets)
    codes, sc, ze = jstore.build_score_rows(jnp.asarray(k), jla, offs, jcfg, quant)
    jss = jax_backend("reference").prefill_score_rows(jnp.asarray(k), jla, offs, jcfg,
                                                      quant)
    rq = j_rank_query(jnp.asarray(q), jcfg.centroid_method, d)
    want, j_att = jops.sparse_prefill(
        jnp.asarray(q), rq, jnp.asarray(k), jnp.asarray(v), jss, jla, sink_pages=1,
        local_pages=4, block_q=BQ, n_valid=jnp.asarray(nv), chunk_offset=off,
        interpret=True)
    tss = CentroidStore(_t(codes), _t(sc), _t(ze), 4, False)
    tq = _t(q)
    got, t_att = tops.sparse_prefill(
        tq, t_rank_query(tq, tcfg.centroid_method, d), _t(k), _t(v), tss, tla,
        sink_pages=1, local_pages=4, block_q=BQ, n_valid=_t(nv), chunk_offset=off)
    assert g * BQ == (512 if g == 8 else 64)
    np.testing.assert_array_equal(np.asarray(j_att), t_att.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "not-causal"])
def test_flash_attention_at_head_dim_256_matches_jax_kernel(causal):
    rng = np.random.default_rng(256 + causal)
    q, k, v = (rng.standard_normal((1, h, 128, 256)).astype(np.float32)
               for h in (4, 2, 2))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                   interpret=True)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("offset", [0, 63, 200])
def test_flash_attention_at_head_dim_256_with_offset_and_key_length(offset):
    """A chunk of 37 queries at ``offset`` over the keys written so far
    (``k_len = offset + 37``) of a 320-row cache row, against JAX's dense
    prefill chunk (queries at ``offset + i``, later rows masked)."""
    rng = np.random.default_rng(offset + 256)
    C, T, d = 37, 320, 256
    q = rng.standard_normal((2, C, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, T, d)).astype(np.float32) for _ in range(2))
    logits = jnp.einsum("hcd,hsd->hcs", jnp.asarray(q), jnp.asarray(k)) / jnp.sqrt(
        jnp.float32(d))
    mask = jnp.arange(T)[None, :] <= (offset + jnp.arange(C))[:, None]
    probs = jax.nn.softmax(jnp.where(mask[None], logits, -1e30), axis=-1)
    want = jnp.einsum("hcs,hsd->hcd", probs, jnp.asarray(v))
    calls = fa.plain_calls
    got = fa.flash_attention(_t(q)[None], _t(k)[None], _t(v)[None], True, offset,
                             offset + C)
    assert fa.plain_calls == calls + 1 and fa.launches == 0
    np.testing.assert_allclose(np.asarray(want), got[0].numpy(), atol=ATOL)
