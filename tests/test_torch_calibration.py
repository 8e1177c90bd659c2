"""Parity of the PyTorch port's calibration pass (paper §3.2, Eq. 2) with the
JAX package, on the CPU.

The JAX side runs its pooling kernel in interpret mode and its reference
store path; the port runs its wrappers on CPU tensors, which take the plain
versions.  Inputs are numpy arrays from a seed, or JAX's own synthetic
heads converted to numpy, fed to both.  Tolerances:

- quest rank keys, store codes / scale / zero, page-token masks and Eq.-2
  assignments: identical;
- mean / arkvale rank keys: within 1e-6 of the row's largest magnitude
  (f32 sums over a block in another order);
- recall: within 1e-5 (f32 softmax and sums in another order);
- engine tokens with a calibrated assignment: identical at temperature 0.

The port's own synthetic heads (torch generators, other numbers than
JAX's) must show what ``tests/test_calibration.py`` asserts of JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_slot_reset import clear_slots_on_install
from repro.backends import get_backend as jax_backend
from repro.config import ServeConfig as JServe
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.core import calibration as jcal
from repro.core import recall as jrecall
from repro.core.ragged import layout_for as j_layout_for
from repro.core.selection import pages_to_token_mask as j_pages_to_token_mask
from repro.kernels import block_centroid as jbc
from repro.kernels import ref as jref
from repro.models import Transformer as JTransformer
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch.backends import get_backend as torch_backend
from repro_torch.config import ServeConfig as TServe
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import calibration as tcal
from repro_torch.core import recall as trecall
from repro_torch.core.ragged import layout_for as t_layout_for
from repro_torch.core.ragged import uniform_layout
from repro_torch.core.selection import pages_to_token_mask as t_pages_to_token_mask
from repro_torch.core.stacked import as_arrays as t_as_arrays
from repro_torch.kernels import block_centroid as tbc
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest

METHODS = ("mean", "quest", "arkvale")
CANDS = (16, 32, 64)
#: the sizes of tests/test_calibration.py
S, D, BUDGET = 4096, 64, 1024
RK_RTOL, RECALL_ATOL = 1e-6, 1e-5


def _np(x):
    return np.asarray(x)


def _close_rows(got, want, what):
    """|got - want| <= RK_RTOL * the row's largest |want| (last axis)."""
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= RK_RTOL * np.maximum(scale, 1e-30)).all(), what


# -- kernel 6: pooling ---------------------------------------------------------


@pytest.mark.parametrize("bs", CANDS)
@pytest.mark.parametrize("method", METHODS)
def test_pool_rank_keys_plain_matches_jax(method, bs):
    keys = np.random.default_rng(bs).standard_normal((2, 3, 256, 64)).astype(np.float32)
    got = tbc.pool_rank_keys(torch.from_numpy(keys), bs, method)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 256 // bs, 128)
    got = got.numpy()
    for want in (jbc.pool_rank_keys(jnp.asarray(keys), bs, method, chunk=128,
                                    interpret=True),
                 jref.pool_rank_keys_ref(jnp.asarray(keys), bs, method)):
        want = _np(want)
        if method == "quest":
            np.testing.assert_array_equal(got, want)
        else:
            _close_rows(got, want, f"{method} rank keys")
    width = {"mean": 64, "quest": 128, "arkvale": 65}[method]
    assert not got[..., width:].any()


def test_pool_rank_keys_rejects_ragged_blocks_and_counts_plain_calls():
    keys = torch.zeros((1, 1, 48, 16))
    with pytest.raises(ValueError, match="multiple of the block size"):
        tbc.pool_rank_keys(keys, 32, "quest")
    before = tbc.plain_calls
    tbc.pool_rank_keys(keys, 16, "quest")
    assert tbc.plain_calls == before + 1


# -- offline store build ---------------------------------------------------------


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("quant", ["none", "int8_asym", "int4_asym"])
def test_build_store_bytes_match_jax(quant, backend):
    blocks, ctx, budget = (16, 32, 64, 32), 512, 128
    keys = np.random.default_rng(11).standard_normal((2, 4, ctx, 16)).astype(np.float32)
    js = jax_backend("reference").build_store(
        jnp.asarray(keys), j_layout_for(blocks, ctx, 16, budget), "quest", quant=quant)
    lay = t_layout_for(blocks, ctx, 16, budget)
    ts = torch_backend(backend).build_store(torch.from_numpy(keys), lay, "quest",
                                            quant=quant)
    np.testing.assert_array_equal(_np(js.codes), ts.codes.numpy())
    assert ts.bits == js.bits and ts.symmetric == js.symmetric
    if quant == "none":
        assert ts.scale is None and ts.zero is None
    else:
        np.testing.assert_array_equal(_np(js.scale), ts.scale.numpy())
        np.testing.assert_array_equal(_np(js.zero), ts.zero.numpy())
    np.testing.assert_array_equal(_np(js.dequantize(j_layout_for(blocks, ctx, 16, budget))),
                                  ts.dequantize(t_as_arrays(lay)).numpy())


# -- recall ----------------------------------------------------------------------


def _jax_heads(n_heads, seed=0):
    """JAX's synthetic heads as numpy: q [n, D], K [n, S, D]."""
    qs, ks, _ = jcal.make_model_like_batch(jax.random.PRNGKey(seed), n_heads, S, D,
                                           BUDGET)
    return np.array(qs), np.array(ks)


def test_recall_primitives_match_jax():
    qs, ks = _jax_heads(3)
    probs_j = jrecall.attention_probs(jnp.asarray(qs), jnp.asarray(ks))
    probs_t = trecall.attention_probs(torch.from_numpy(qs), torch.from_numpy(ks))
    np.testing.assert_allclose(probs_t.numpy(), _np(probs_j), rtol=1e-5, atol=1e-9)
    mask = np.random.default_rng(0).random((3, S)) < 0.3
    np.testing.assert_allclose(
        trecall.recall_from_mask(probs_t, torch.from_numpy(mask)).numpy(),
        _np(jrecall.recall_from_mask(probs_j, jnp.asarray(mask))), atol=RECALL_ATOL)
    for budget in (64, 1024, 2 * S):
        np.testing.assert_allclose(
            trecall.oracle_topk_mass(probs_t, budget).numpy(),
            _np(jrecall.oracle_topk_mass(probs_j, budget)), atol=RECALL_ATOL)


@pytest.mark.parametrize("blocks", [(16, 32, 64, 32), (64, 64, 16, 16)])
def test_pages_to_token_mask_matches_jax(blocks):
    from repro.core.selection import select_page_table as j_select
    from repro_torch.core.selection import select_page_table as t_select

    ctx, budget = 512, 128
    jl, tl = j_layout_for(blocks, ctx, 16, budget), t_layout_for(blocks, ctx, 16, budget)
    la = t_as_arrays(tl)
    rng = np.random.default_rng(2)
    sj = jnp.asarray(rng.standard_normal((2, 4, jl.max_blocks)).astype(np.float32))
    tbl_j, vld_j = j_select(sj, jl, sink_pages=1, local_pages=4)
    tbl_t, vld_t = t_select(torch.from_numpy(np.array(sj)), la,
                            torch.full((2,), ctx, dtype=torch.int32), 1, 4)
    want = _np(j_pages_to_token_mask(tbl_j, vld_j, jl))
    np.testing.assert_array_equal(t_pages_to_token_mask(tbl_t, vld_t, la).numpy(), want)
    # an invalid slot never counts, whatever page it holds
    bad = torch.zeros_like(vld_t)
    assert not t_pages_to_token_mask(tbl_t, bad, la).any()


@pytest.mark.parametrize("quant", ["none", "int4_asym"])
def test_head_recall_matches_jax(quant):
    qs, ks = _jax_heads(3, seed=4)
    for bs in CANDS:
        got = tcal.head_recall_at_block_size(
            torch.from_numpy(qs), torch.from_numpy(ks), bs, BUDGET, quant=quant,
            backend="cuda")
        for h in range(3):
            want = jcal.head_recall_at_block_size(
                jnp.asarray(qs[h]), jnp.asarray(ks[h]), bs, BUDGET, quant=quant)
            assert abs(float(got[h]) - float(want)) <= RECALL_ATOL, (bs, h)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_batched_heads_equal_per_head(backend):
    qs, ks = _jax_heads(3, seed=5)
    qt, kt = torch.from_numpy(qs), torch.from_numpy(ks)
    for bs in CANDS:
        batched = tcal.head_recall_at_block_size(qt, kt, bs, BUDGET, quant="int4_asym",
                                                 backend=backend)
        single = torch.stack([
            tcal.head_recall_at_block_size(qt[h], kt[h], bs, BUDGET,
                                           quant="int4_asym", backend=backend)
            for h in range(3)])
        assert torch.equal(batched, single)


@pytest.mark.parametrize("tau", [0.5, 0.9, 0.98, 0.999])
def test_assign_block_sizes_matches_jax(tau):
    rec = np.random.default_rng(int(tau * 1000)).uniform(0.3, 1.0, (5, 7, 3))
    rec[0, 0] = rec[0, 0, 0]              # an exact tie with B_min
    np.testing.assert_array_equal(tcal.assign_block_sizes(rec, CANDS, tau),
                                  jcal.assign_block_sizes(rec, CANDS, tau))


def test_uniform_layout_matches_layout_for():
    assert uniform_layout(3, 32, 512, 16, 128) == t_layout_for((32,) * 3, 512, 16, 128)


# -- the port's own synthetic heads (tests/test_calibration.py's claims) -----------


def _key(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def recall_profile():
    return tcal.profile_heads(_key(0), 6, S, D, CANDS, BUDGET, n_samples=3)


def test_heterogeneous_sensitivity(recall_profile):
    rec = recall_profile
    for h in (0, 3):                      # insensitive heads stay flat
        assert rec[h, 2] >= 0.97 * rec[h, 0], h
    for h in (2, 5):                      # needle heads degrade at B = 64
        assert rec[h, 2] <= 0.85 * rec[h, 0], h


def test_recall_monotone_in_block_size(recall_profile):
    rec = recall_profile
    assert (rec[:, 0] + 1e-3 >= rec[:, 1]).all()
    assert (rec[:, 1] + 1e-3 >= rec[:, 2]).all()


def test_eq2_assignment(recall_profile):
    sizes = tcal.assign_block_sizes(recall_profile, CANDS, tau=0.98)
    assert sizes[0] == 64 and sizes[3] == 64
    assert sizes[2] == 16 and sizes[5] == 16


def test_assignment_monotone_in_tau(recall_profile):
    prev = None
    for tau in (0.5, 0.9, 0.98, 0.999):
        sizes = tcal.assign_block_sizes(recall_profile, CANDS, tau)
        if prev is not None:
            assert (sizes <= prev).all(), (tau, sizes, prev)
        prev = sizes


def test_adaptive_beats_uniform_at_matched_average(recall_profile):
    rec = recall_profile
    sizes = tcal.assign_block_sizes(rec, CANDS, tau=0.98)
    adaptive = np.mean([rec[h, CANDS.index(int(sizes[h]))] for h in range(6)])
    assert sizes.mean() >= 32 - 1e-9
    assert adaptive > rec[:, 1].mean() + 0.02


def test_generator_makes_the_same_heads_and_others_per_seed():
    a = tcal.make_model_like_batch(_key(3), 3, 1024, 16, 256)
    b = tcal.make_model_like_batch(_key(3), 3, 1024, 16, 256)
    c = tcal.make_model_like_batch(_key(4), 3, 1024, 16, 256)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])
    assert a[2] == ("insensitive", "mid", "needle")


# -- calibrate_for_config -> serving ----------------------------------------------

SPARSE = dict(token_budget=128, sparse_prefill=True, prefill_block_q=64)
SERVE = dict(max_batch=2, max_context=512, prefill_chunk=128,
             prefill_tokens_per_tick=192, temperature=0.0)


def test_calibrate_for_config_serves_token_identical_to_jax():
    tb = t_smoke(t_get_config("llama3.2-3b"))
    tcfg = dataclasses.replace(tb, sparse=dataclasses.replace(
        tb.sparse, backend="cuda", fused_decode=True, **SPARSE))
    new_cfg, res = tcal.calibrate_for_config(_key(0), tcfg, seq_len=512, n_samples=2,
                                             backend="cuda", device="cpu")
    assert res.block_sizes.shape == (tcfg.n_layers, tcfg.n_kv_heads)
    assert res.tau == tcfg.sparse.tau == 0.98
    assert new_cfg.sparse.block_sizes == res.as_tuple()
    assert set(res.block_sizes.flat) <= set(CANDS)
    np.testing.assert_array_equal(res.block_sizes,
                                  tcal.assign_block_sizes(res.recall, CANDS, 0.98))

    jb = j_smoke(j_get_config("llama3.2-3b"))
    jcfg = dataclasses.replace(jb, sparse=dataclasses.replace(
        jb.sparse, backend="reference", block_sizes=res.as_tuple(), **SPARSE))
    params = JTransformer(jcfg).init(jax.random.PRNGKey(3))
    model = params_from_jax(jax.tree.map(np.asarray, params), new_cfg, device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (300, 170)]
    jeng = clear_slots_on_install(JEngine(jcfg, params, JServe(**SERVE), seed=0))
    teng = TEngine(new_cfg, model, TServe(**SERVE), seed=0, device="cpu")
    for eng, Req in ((jeng, JRequest), (teng, TRequest)):
        for i, p in enumerate(prompts):
            eng.submit(Req(req_id=i, prompt=p, max_new_tokens=6))
    jout = {r.req_id: list(r.output) for r in jeng.run_until_done()}
    tout = {r.req_id: list(r.output) for r in teng.run_until_done()}
    assert tout == jout and all(len(o) == 6 for o in tout.values())


def test_calibration_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CPU-only rule is moot")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcal.calibrate(_key(0), 1, 1, 16, seq_len=256, token_budget=64, n_samples=1)
    with pytest.raises(ValueError, match="generator"):
        tcal.calibrate(_key(0), 1, 1, 16, seq_len=256, token_budget=64, n_samples=1,
                       device="meta")
