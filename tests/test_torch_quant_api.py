"""The port's generic quantization API (``repro_torch.core.quantization``:
the paper's §3.3 ablation ladder), ``core.estimation`` and the stray
``core`` / ``backends`` functions, held to the JAX package on the same
inputs (made with numpy from a seed).

Codes, scale and zero are byte-identical to JAX's for all six schemes, per
channel and per tensor, with and without ``reduce_axes`` and ``pack``, and
so are the dequantized values: the port keeps JAX's operation order, and
both round half to even.  Scores sum Dp products in another order than
XLA's, so they are held at rtol 1e-5; selections made from them are equal
but for near ties under ``kernels.parity``'s rule, which are counted.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import centroids as j_cent
from repro.core import estimation as j_est
from repro.core import quantization as jq
from repro.core import ragged as j_ragged
from repro.core import selection as j_sel
from repro.core import sparse_attention as j_sa
from repro_torch import core as t_core
from repro_torch.backends import available_backends
from repro_torch.core import centroids as t_cent
from repro_torch.core import estimation as t_est
from repro_torch.core import quantization as tq
from repro_torch.core import ragged as t_ragged
from repro_torch.core import selection as t_sel
from repro_torch.core import sparse_attention as t_sa
from repro_torch.core.stacked import as_arrays
from repro_torch.kernels import parity

SCHEMES = ["int8_asym", "int8_sym", "int4_asym", "int4_sym", "int2_asym", "int2_sym"]
#: (channel_axis, reduce_axes) of a [3, 5, 16] input: per channel on the
#: last and the first axis, per tensor, and per (row, channel) over axis 1
AXES = [(-1, None), (0, None), (None, None), (-1, (1,))]
METHODS = ("mean", "quest", "arkvale")
#: estimate_scores against JAX's (summation orders differ)
SCORE_RTOL = 1e-5


def _x(seed=0, shape=(3, 5, 16)):
    rng = np.random.default_rng(seed)
    spread = rng.uniform(0.1, 3.0, shape[-1]).astype(np.float32)
    return (rng.standard_normal(shape) * spread).astype(np.float32)


def _same(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantize_codes_params_and_dequant_equal_jax(scheme):
    x = _x()
    for channel_axis, reduce_axes in AXES:
        for pack in (False, True):
            what = (scheme, channel_axis, reduce_axes, pack)
            a = jq.quantize(jnp.asarray(x), scheme, channel_axis, reduce_axes, pack)
            b = tq.quantize(torch.from_numpy(x), scheme, channel_axis, reduce_axes,
                            pack)
            assert b.codes.dtype == torch.uint8, what
            assert _same(a.codes, b.codes), what           # bytes, packed or not
            assert _same(a.scale, b.scale) and _same(a.zero, b.zero), what
            assert (a.bits, a.packed, a.symmetric, a.logical_shape) == (
                b.bits, b.packed, b.symmetric, b.logical_shape), what
            assert a.nbytes_codes == b.nbytes_codes, what
            # dequantized values equal to the bit: same op order, f32
            assert _same(jq.dequantize(a), tq.dequantize(b)), what
            assert _same(jq.quantization_error_bound(a),
                         tq.quantization_error_bound(b)), what
        assert _same(jq.fake_quantize(jnp.asarray(x), scheme, channel_axis),
                     tq.fake_quantize(torch.from_numpy(x), scheme, channel_axis))
    assert (tq.scheme_bits(scheme), tq.scheme_symmetric(scheme)) == (
        jq.scheme_bits(scheme), jq.scheme_symmetric(scheme))


def test_quantize_one_axis_input_reduces_nothing_per_channel():
    """A 1-D input per channel reduces over no axis (``jnp.max`` over
    ``axis=()``); ``torch.amax`` with an empty ``dim`` would reduce all."""
    x = _x(shape=(16,))
    for scheme in ("int4_asym", "int8_sym"):
        a = jq.quantize(jnp.asarray(x), scheme)
        b = tq.quantize(torch.from_numpy(x), scheme)
        assert b.scale.shape == (16,)
        assert _same(a.codes, b.codes) and _same(a.scale, b.scale)


@pytest.mark.parametrize("scheme", ["int4_asym", "int4_sym", "int2_asym", "int2_sym"])
def test_pack_codes_bytes_and_roundtrip(scheme):
    """Packing along the last axis, low bits first: JAX's bytes from its
    uint32 shifts, the port's from int32; unpack restores the codes."""
    x = _x(1, (4, 6, 32))
    a = jq.pack_codes(jq.quantize(jnp.asarray(x), scheme))
    qt = tq.quantize(torch.from_numpy(x), scheme)
    b = tq.pack_codes(qt)
    assert b.packed and b.codes.shape[-1] == 32 * qt.bits // 8
    assert _same(a.codes, b.codes)
    assert torch.equal(tq.unpack_codes(b).codes, qt.codes)
    assert tq.pack_codes(b) is b and tq.unpack_codes(qt) is qt
    # INT8 packs to itself; a last axis off the byte grid raises
    q8 = tq.quantize(torch.from_numpy(x), "int8_asym")
    assert tq.pack_codes(q8) is q8
    with pytest.raises(ValueError, match="multiple of"):
        tq.quantize(torch.from_numpy(_x(1, (4, 6))), "int2_asym", pack=True)


@pytest.mark.parametrize("scheme", ["int8_asym", "int8_sym", "int4_asym", "int4_sym",
                                    "int2_asym"])
def test_roundtrip_error_bound(scheme):
    """JAX's property 2 (``tests/test_quantization.py``): the round trip
    moves no value by more than scale / 2."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 128))
                         .astype(np.float32) * 3.0)
    qt = tq.quantize(x, scheme, channel_axis=-1)
    err = (tq.dequantize(qt) - x).abs()
    assert bool((err <= tq.quantization_error_bound(qt) + 1e-5).all())


def test_fake_quantize_as_jax_holds_it():
    """Per channel beats per tensor on column-structured data (paper Fig.
    7), codes are monotone within a channel, a planted winner survives the
    quantized scores, and ``"none"`` is the f32 input."""
    rng = np.random.default_rng(3)
    x = torch.linspace(-8, 8, 128)[None, :] + 0.1 * torch.from_numpy(
        rng.standard_normal((256, 128)).astype(np.float32))
    err_pc = (tq.fake_quantize(x, "int4_asym", channel_axis=-1) - x).abs().mean()
    err_pt = (tq.fake_quantize(x, "int4_asym", channel_axis=None) - x).abs().mean()
    assert err_pc < 0.25 * err_pt
    for scheme in SCHEMES:
        xs = torch.from_numpy(np.sort(rng.standard_normal((32, 64)), axis=0)
                              .astype(np.float32))
        codes = tq.quantize(xs, scheme).codes.to(torch.int32)
        assert bool((codes.diff(dim=0) >= 0).all()), scheme
    for scheme in ("int4_asym", "int8_asym"):
        rk = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
        qv = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
        rk[7] = 5.0 * qv / qv.norm()
        assert int((tq.fake_quantize(rk, scheme) @ qv).argmax()) == 7
    xb = x.to(torch.bfloat16)
    assert torch.equal(tq.fake_quantize(xb, "none"), xb.float())
    assert t_core.quantize is tq.quantize and t_core.QuantizedTensor is tq.QuantizedTensor


# ---------------------------------------------------------------- estimation

#: per-head block sizes of a 4-kv-head layout, context 512, budget 128
BLOCKS, CTX, PS, BUDGET = (16, 32, 64, 32), 512, 16, 128


def _layouts():
    return (j_ragged.layout_for(BLOCKS, CTX, PS, BUDGET),
            t_ragged.layout_for(BLOCKS, CTX, PS, BUDGET))


def _scoring_inputs(seed, g=2, Dp=128):
    jl, _ = _layouts()
    rng = np.random.default_rng(seed)
    B = 2
    rq = rng.standard_normal((B, len(BLOCKS) * g, Dp)).astype(np.float32)
    rk = rng.standard_normal((B, jl.total_rows, Dp)).astype(np.float32)
    return rq, rk


def _close(a, b, what):
    a, b = np.asarray(a), b.numpy()
    real = a > -1e29
    assert np.array_equal(real, b > -1e29), what
    assert np.array_equal(a[~real], b[~real]), what
    np.testing.assert_allclose(b[real], a[real], rtol=SCORE_RTOL, atol=1e-6,
                               err_msg=what)


@pytest.mark.parametrize("granularity", ["kv_head", "q_head"])
def test_estimate_scores_plain_and_quantized_match_jax(granularity):
    jl, tl = _layouts()
    rq, rk = _scoring_inputs(4)
    H = len(BLOCKS)
    for quant in (None, "int4_asym", "int8_sym"):
        if quant is None:
            jk, tk = jnp.asarray(rk), torch.from_numpy(rk)
        else:
            # per (sequence, channel), reduced over the store's rows
            jk = jq.quantize(jnp.asarray(rk), quant, reduce_axes=(1,),
                             pack=quant.startswith("int4"))
            tk = tq.quantize(torch.from_numpy(rk), quant, reduce_axes=(1,),
                             pack=quant.startswith("int4"))
        want = j_est.estimate_scores(jnp.asarray(rq), jk, jl, H, granularity)
        for layout in (tl, as_arrays(tl)):
            got = t_est.estimate_scores(torch.from_numpy(rq), tk, layout, H,
                                        granularity)
            assert got.shape == want.shape and got.dtype == torch.float32
            _close(want, got, (granularity, quant, type(layout).__name__))
    with pytest.raises(ValueError, match="granularity"):
        t_est.estimate_scores(torch.from_numpy(rq), torch.from_numpy(rk), tl, H,
                              "block")


@pytest.mark.parametrize("method", METHODS)
def test_dense_oracle_and_reference_block_score_match_jax(method):
    jl, tl = _layouts()
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 8, 64)).astype(np.float32)
    keys = rng.standard_normal((2, 4, CTX, 64)).astype(np.float32)
    for gran in ("kv_head", "q_head"):
        want = j_est.estimate_scores_dense_oracle(jnp.asarray(q), jnp.asarray(keys),
                                                  jl, method, gran)
        got = t_est.estimate_scores_dense_oracle(torch.from_numpy(q),
                                                 torch.from_numpy(keys), tl, method,
                                                 gran)
        assert got.shape == want.shape
        _close(want, got, (method, gran))
    for bs in (16, 32, 64):
        want = j_cent.reference_block_score(jnp.asarray(q[0, 0]),
                                            jnp.asarray(keys[0, 0]), bs, method)
        got = t_cent.reference_block_score(torch.from_numpy(q[0, 0]),
                                           torch.from_numpy(keys[0, 0]), bs, method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        # the unified rank-key formulation reproduces the direct formula
        rk = t_cent.build_rank_keys(torch.from_numpy(keys[0, 0])[None], bs, method)[0]
        rqv = t_cent.rank_query(torch.from_numpy(q[0, 0])[None], method, 64)[0]
        np.testing.assert_allclose((rk @ rqv).numpy(), got.numpy(), rtol=1e-5,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="unknown centroid method"):
        t_cent.reference_block_score(torch.from_numpy(q[0, 0]),
                                     torch.from_numpy(keys[0, 0]), 16, "max")


def test_selection_from_port_scores_equals_jax_up_to_near_ties():
    """Page tables selected from the port's scores equal JAX's from its own,
    but for near ties (``kernels.parity``'s rule), which are counted."""
    jl, tl = _layouts()
    la = as_arrays(tl)
    live = np.array([CTX, 300], np.int32)
    ties = 0
    for seed in range(6):
        rq, rk = _scoring_inputs(seed)
        js = j_est.estimate_scores(jnp.asarray(rq), jnp.asarray(rk), jl, len(BLOCKS))
        ts = t_est.estimate_scores(torch.from_numpy(rq), torch.from_numpy(rk), tl,
                                   len(BLOCKS))
        jt, jv = j_sel.select_page_table(js, jl, jnp.asarray(live), 1, 1)
        tt, tv = t_sel.select_page_table(ts, la, torch.from_numpy(live), 1, 1)
        assert _same(jv, tv)
        diff = parity._selection_diff(ts, la, 1, 1, torch.from_numpy(live), tt,
                                      torch.from_numpy(np.array(jt)), tv, "estimate")
        ties += int(diff.sum())
    assert ties <= 2, f"{ties} near-tie blocks in 6 draws"


def test_gather_pages_budget_check_and_backends():
    rng = np.random.default_rng(9)
    kv = rng.standard_normal((2, 4, CTX // PS, PS, 8)).astype(np.float32)
    table = rng.integers(0, CTX // PS, (2, 4, 8)).astype(np.int32)
    want = j_sa.gather_pages(jnp.asarray(kv), jnp.asarray(table), PS)
    for x in (kv, kv.reshape(2, 4, CTX, 8)):          # paged and dense
        got = t_sa.gather_pages(torch.from_numpy(x), torch.from_numpy(table), PS)
        assert _same(want, got)
    jl, tl = _layouts()
    assert t_sel.uniform_token_budget_check(tl) == j_sel.uniform_token_budget_check(jl)
    assert t_sel.uniform_token_budget_check(tl) == tl.token_budget
    assert available_backends() == ("cuda", "dense", "reference")
