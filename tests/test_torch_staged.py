"""Parity of the port's staged decode and sparsity telemetry with the JAX
package, on the CPU.

Inputs are made with numpy from a seed and fed to both.  The JAX Pallas
kernels run with ``interpret=True``; the port's kernel wrappers run their
plain versions on CPU tensors.

- ``centroid_scores``: every quant scheme on non-uniform layouts; scores
  within ``SCORE_RTOL`` of each (sequence, head)'s largest |score| (f32,
  the two sum a row's products in different orders), and the page tables
  selected from them identical;
- ``paged_attention``: ragged ``seq_len``, invalid slots, GQA groups 1, 3
  and 8; f32 within 1e-5, bf16 within one bf16 rounding step
  (:mod:`repro_torch.kernels.parity`);
- staged decode through the ``"cuda"`` backend against JAX's
  ``"reference"`` backend: page tables identical, outputs within 1e-5,
  counters identical; against the port's fused decode: same page sets,
  outputs within 1e-5, counters identical;
- ``selection_telemetry`` and ``Engine(telemetry=True)``'s sparsity snapshot
  equal to JAX's, and equal for the fused and the staged decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_slot_reset import clear_slots_on_install
from repro.backends import get_backend as jax_backend
from repro.backends import store as jstore
from repro.config import ServeConfig as JServe
from repro.config import SparseConfig as JSparse
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.core.centroids import rank_query as j_rank_query
from repro.core.ragged import layout_for as j_layout_for
from repro.core.selection import select_page_table as j_select
from repro.core.selection import selection_telemetry as j_telemetry
from repro.core.stacked import as_arrays as j_as_arrays
from repro.kernels import ops as jops
from repro.models import Transformer as JTransformer
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch.backends import CentroidStore, get_backend
from repro_torch.config import ServeConfig as TServe
from repro_torch.config import SparseConfig as TSparse
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core.centroids import rank_query as t_rank_query
from repro_torch.core.ragged import layout_for as t_layout_for
from repro_torch.core.selection import select_page_table as t_select
from repro_torch.core.selection import selection_telemetry as t_telemetry
from repro_torch.core.stacked import as_arrays as t_as_arrays
from repro_torch.kernels import centroid_score, ops as tops, paged_attention, parity, ref
from repro_torch.obs.telemetry import BLOCKS, BUDGET, FORCED, PAGES
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest

B, N_KV, G, S, D, PS, BUDGET_T = 2, 4, 2, 512, 16, 16, 128
LAYOUTS = {
    "nonuniform": (16, 32, 64, 32),
    "mixed": (64, 16, 16, 32),
}
QUANTS = ["none", "int8_asym", "int8_sym", "int4_asym", "int4_sym"]
#: f32 scores: |port - JAX| <= SCORE_RTOL * max |score| of the (sequence,
#: head); the two sum Dp products in different orders (a few ulps of the
#: largest partial sums)
SCORE_RTOL = 1e-5
SEQ = (S, 301)


def _t(x):
    return torch.from_numpy(np.array(x))


def _page_sets(table, valid):
    t, m = np.asarray(table), np.asarray(valid)
    return {
        (b, h): sorted(t[b, h][m[b, h]].tolist())
        for b in range(t.shape[0]) for h in range(t.shape[1])
    }


def _store_case(quant, blocks, seed, sink=1, local=4):
    kw = dict(token_budget=BUDGET_T, quant=quant, sink_pages=sink,
              local_pages=local)
    jcfg, tcfg = JSparse(**kw), TSparse(**kw)
    jla = j_as_arrays(j_layout_for(blocks, S, PS, BUDGET_T))
    tla = t_as_arrays(t_layout_for(blocks, S, PS, BUDGET_T))
    rng = np.random.default_rng(seed)
    shape = (B, N_KV, S // PS, PS, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((B, N_KV * G, D)).astype(np.float32)
    jst = jstore.build_store_codes(jnp.asarray(k), jla, jnp.asarray(jla.row_offsets),
                                   jcfg, quant)
    tst = CentroidStore(_t(jst.codes), _t(jst.scale), _t(jst.zero), jst.bits,
                        jst.symmetric)
    return jcfg, tcfg, jla, tla, k, v, q, jst, tst


# -- centroid scores -----------------------------------------------------------


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
def test_centroid_scores_match_jax_kernel(quant, blocks):
    jcfg, tcfg, jla, tla, k, v, q, jst, tst = _store_case(quant, blocks, seed=1)
    rq = j_rank_query(jnp.asarray(q), jcfg.centroid_method, D)
    want = np.asarray(jops.centroid_scores(rq, jst, jla, N_KV, interpret=True))

    trq = t_rank_query(_t(q), tcfg.centroid_method, D)
    name = "centroid_scores_f32" if quant == "none" else "centroid_scores_quantized"
    calls = centroid_score.plain_calls[name]
    got = tops.centroid_scores(trq, tst, tla, N_KV)
    assert centroid_score.plain_calls[name] == calls + 1
    assert centroid_score.launches[name] == 0
    flat = ref.centroid_scores_ref(trq, tst.codes, tst.scale, tst.zero,
                                   tla.tile_head, tla.tile_rows, tst.bits,
                                   tst.symmetric, n_kv=N_KV)
    assert torch.equal(tops.flat_to_padded(flat, tla), got)

    pad = np.asarray(jla.pad_mask)[None]
    np.testing.assert_array_equal(want[~np.broadcast_to(pad, want.shape)],
                                  got.numpy()[~np.broadcast_to(pad, want.shape)])
    scale = np.abs(np.where(pad, want, 0.0)).max(-1, keepdims=True)
    err = np.abs(np.where(pad, want - got.numpy(), 0.0))
    assert (err <= SCORE_RTOL * scale).all(), float((err / scale).max())

    sl = np.asarray(SEQ, np.int32)
    j_tbl, j_vld = j_select(jnp.asarray(want), jla, seq_len=jnp.asarray(sl))
    t_tbl, t_vld = t_select(got, tla, _t(sl))
    np.testing.assert_array_equal(np.asarray(j_tbl), t_tbl.numpy())
    np.testing.assert_array_equal(np.asarray(j_vld), t_vld.numpy())


# -- paged attention -----------------------------------------------------------


@pytest.mark.parametrize("g", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_jax_kernel(g, dtype):
    n_kv = 2
    lay_t = t_as_arrays(t_layout_for((16, 32), S, PS, BUDGET_T))
    rng = np.random.default_rng(g)
    shape = (B, n_kv, S // PS, PS, D)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    q = (rng.standard_normal((B, n_kv * g, D)) * parity.QSCALE).astype(np.float32)
    scores = rng.standard_normal((B, n_kv, lay_t.max_blocks)).astype(np.float32)
    sl = np.asarray((S - 5, 100), np.int32)          # ragged, short -> invalid slots
    tbl, vld = t_select(_t(scores), lay_t, _t(sl))
    # drop a few more slots at random; slot 0 (the sink block) stays valid
    vld = vld & _t(rng.random(vld.shape) > 0.25)
    vld[..., 0] = True
    assert not bool(vld.all())

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jops.paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(tbl.numpy()), jnp.asarray(vld.numpy()), PS,
        jnp.asarray(sl), interpret=True,
    )
    want = _t(want.astype(jnp.float32))
    calls = paged_attention.plain_calls
    got = tops.paged_attention(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt),
                               tbl, vld, PS, _t(sl))
    assert paged_attention.plain_calls == calls + 1 and paged_attention.launches == 0
    assert got.dtype == tdt and got.shape == (B, n_kv * g, D)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    else:
        keep = torch.ones(got.shape[:-1], dtype=torch.bool)
        parity.check_outputs(got, want, keep, "paged_attention")


# -- staged decode through the backend ---------------------------------------------


@pytest.mark.parametrize("quant", ["none", "int8_asym", "int4_asym", "int4_sym"])
@pytest.mark.parametrize("blocks", list(LAYOUTS.values()), ids=list(LAYOUTS))
@pytest.mark.parametrize("sink,local", [(0, 0), (1, 4)])
def test_staged_decode_matches_jax_reference_and_port_fused(quant, blocks, sink,
                                                            local):
    jcfg, tcfg, jla, tla, k, v, q, jst, tst = _store_case(
        quant, blocks, seed=3, sink=sink, local=local)
    sl = np.asarray(SEQ, np.int32)
    j_out, j_tbl, j_tel = jax_backend("reference").decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jst, jla, jcfg,
        seq_len=jnp.asarray(sl), collect_tel=True,
    )
    cuda = get_backend("cuda")
    args = (_t(q), _t(k), _t(v), tst, tla)
    s_out, s_tbl, s_vld, s_tel = cuda.decode(*args, tcfg, _t(sl), collect_tel=True)
    np.testing.assert_array_equal(np.asarray(j_tbl), s_tbl.numpy())
    np.testing.assert_allclose(np.asarray(j_out), s_out.numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(j_tel), s_tel.numpy())

    fused = dataclasses.replace(tcfg, fused_decode=True)
    f_out, f_tbl, f_vld, f_tel = cuda.decode(*args, fused, _t(sl), collect_tel=True)
    assert _page_sets(f_tbl, f_vld) == _page_sets(s_tbl, s_vld)
    np.testing.assert_allclose(f_out.numpy(), s_out.numpy(), atol=1e-5)
    assert torch.equal(f_tel, s_tel)

    # the reference backend decodes staged whatever fused_decode says
    r_out, r_tbl, r_vld = get_backend("reference").decode(*args, fused, _t(sl))
    assert torch.equal(r_tbl, s_tbl) and torch.equal(r_out, s_out)


# -- telemetry -----------------------------------------------------------------


@pytest.mark.parametrize("blocks", [(32, 64), (16, 32, 64, 32)])
@pytest.mark.parametrize("sink,local", [(1, 4), (0, 0), (2, 1)])
def test_selection_telemetry_matches_jax(blocks, sink, local):
    lay = (256, 16, 128)
    jla = j_as_arrays(j_layout_for(blocks, *lay))
    tla = t_as_arrays(t_layout_for(blocks, *lay))
    scores = np.random.default_rng(1).standard_normal(
        (3, len(blocks), tla.max_blocks)).astype(np.float32)
    sl = np.asarray((256, 64, 1), np.int32)
    want = j_telemetry(jnp.asarray(scores), jla, seq_len=jnp.asarray(sl),
                       sink_pages=sink, local_pages=local)
    got = t_telemetry(_t(scores), tla, _t(sl), sink, local)
    assert got.dtype == torch.int32 and got.shape == (3, 4)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    full = t_telemetry(_t(scores), tla, None, sink, local)
    if blocks == (32, 64) and (sink, local) == (1, 4):
        # budget 128/32 + 128/64, all filled at full context; pages per
        # head = blocks x pages per block; sink + local pins (2 for B = 32,
        # 1 for B = 64 with a 4-page window)
        assert (full[:, BUDGET] == 6).all() and (full[:, BLOCKS] == 6).all()
        assert (full[:, PAGES] == 4 * 2 + 2 * 4).all()
        assert (full[:, FORCED] == 5).all()
    _, valid = t_select(_t(scores), tla, _t(sl), sink, local)
    assert torch.equal(got[:, PAGES], valid.sum(dim=(1, 2)).to(torch.int32))


SPARSE = dict(token_budget=128, block_sizes=((16, 32), (64, 16)),
              sparse_prefill=True, prefill_block_q=64)
SERVE = dict(max_batch=2, max_context=512, prefill_chunk=128,
             prefill_tokens_per_tick=192, temperature=0.0)
SPARSITY_KEYS = ("sparsity_steps", "blocks_per_step", "pages_per_step",
                 "budget_utilization", "forced_frac", "prefill_chunks",
                 "prefill_blocks_attended", "prefill_blocks_frac",
                 "budget_util_hist")


def test_engine_telemetry_snapshot_matches_jax_for_fused_and_staged():
    jb, tb = j_smoke(j_get_config("llama3.2-3b")), t_smoke(t_get_config("llama3.2-3b"))
    jcfg = dataclasses.replace(
        jb, sparse=dataclasses.replace(jb.sparse, backend="reference", **SPARSE))
    params = JTransformer(jcfg).init(jax.random.PRNGKey(5))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (300, 170, 90)]

    def serve(eng, Req):
        for i, p in enumerate(prompts):
            eng.submit(Req(req_id=i, prompt=p, max_new_tokens=6))
        out = {r.req_id: list(r.output) for r in eng.run_until_done()}
        return out, eng.metrics.snapshot()

    jeng = clear_slots_on_install(JEngine(jcfg, params, JServe(**SERVE), seed=0,
                                          telemetry=True))
    jout, jsnap = serve(jeng, JRequest)
    for fused in (True, False):
        tcfg = dataclasses.replace(tb, sparse=dataclasses.replace(
            tb.sparse, backend="cuda", fused_decode=fused, **SPARSE))
        model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
        teng = TEngine(tcfg, model, TServe(**SERVE), seed=0, device="cpu",
                       telemetry=True)
        tout, tsnap = serve(teng, TRequest)
        assert tout == jout
        assert jsnap["sparsity_steps"] > 0 and jsnap["prefill_chunks"] > 0
        for key in SPARSITY_KEYS:
            assert tsnap[key] == jsnap[key], (fused, key)


def test_engine_without_telemetry_plants_no_counters():
    tb = t_smoke(t_get_config("llama3.2-3b"))
    cfg = dataclasses.replace(tb, sparse=dataclasses.replace(tb.sparse, **SPARSE))
    from repro_torch.models import Transformer

    eng = TEngine(cfg, Transformer(cfg, device="cpu"), TServe(**SERVE), device="cpu")
    assert "_telemetry" not in eng.cache and "_ptel" not in eng.cache
    assert "sparsity_steps" not in eng.metrics.snapshot()
