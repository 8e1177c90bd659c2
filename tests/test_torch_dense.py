"""Parity of the port's dense paths with the JAX package, on the CPU.

The repo's default configuration prefills densely (``SparseConfig.
sparse_prefill`` False) and decodes sparsely; an inactive plan (context
under twice the budget) decodes densely and holds no store; the ``"dense"``
backend is the Full Attention baseline.  Inputs are made with numpy from a
seed and fed to both packages; the port's kernel wrappers run their plain
versions on CPU tensors.

- primitives: ``as_dense``, ``dense_decode_attention`` and
  ``chunked_causal_attention`` (both of JAX's orders) within 1e-5 (f32);
- the flash kernel's plain version with a query offset and a key length
  against JAX's masked dense chunk (``Transformer.prefill_chunk``'s dense
  branch) and JAX's ``DenseBackend.prefill_attention``, at offsets 0, 1,
  63, 64 and 200 with ragged key lengths, within 1e-5;
- the port's ``"reference"`` and ``"cuda"`` backends (fused and staged)
  equal to its ``"dense"`` backend at full budget on the grid of
  ``tests/test_backends.py`` (atol 2e-5, rtol 1e-4), and ``"dense"`` equal
  to JAX's;
- model logits within 1e-4 (f32) and greedy tokens identical to JAX with
  sparse prefill off (fused and staged decode), an inactive plan (a
  ``max_context`` that is not a multiple of the page size), the
  ``"dense"`` backend, and chunked dense prefill at unaligned offsets.

Engine token streams are held against JAX's in
``tests/test_torch_dense_engine.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import get_backend as jax_backend
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.core import sparse_attention as jsa
from repro.models import Transformer as JTransformer
from repro.models import layers as jlayers
from repro.models.transformer import _attn_chunk as j_attn_chunk

from repro_torch.backends import DenseBackend, get_backend
from repro_torch.config import SparseConfig as TSparse
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import sparse_attention as tsa
from repro_torch.core.ragged import layout_for as t_layout_for
from repro_torch.core.stacked import as_arrays as t_as_arrays
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import layers as tlayers

ATOL = 1e-4
OFFSETS = (0, 1, 63, 64, 200)


def _t(x):
    return torch.from_numpy(np.array(x))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- primitives ------------------------------------------------------------------


def test_as_dense_views_the_paged_cache():
    rng = np.random.default_rng(0)
    paged = _t(_normal(rng, 2, 3, 5, 16, 8))
    dense = tsa.as_dense(paged)
    assert dense.shape == (2, 3, 80, 8)
    assert dense.data_ptr() == paged.data_ptr()
    np.testing.assert_array_equal(np.asarray(jsa.as_dense(jnp.asarray(paged.numpy()))),
                                  dense.numpy())
    assert tsa.as_dense(dense) is dense


@pytest.mark.parametrize("seq", [None, (300, 17)], ids=["all", "ragged"])
def test_dense_decode_attention_matches_jax(seq):
    rng = np.random.default_rng(1)
    q, k, v = _normal(rng, 2, 6, 32), _normal(rng, 2, 2, 300, 32), _normal(rng, 2, 2, 300, 32)
    sl = None if seq is None else np.asarray(seq, np.int32)
    want = jsa.dense_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      seq_len=None if sl is None else jnp.asarray(sl))
    got = tsa.dense_decode_attention(_t(q), _t(k), _t(v),
                                     None if sl is None else _t(sl))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=1e-5)


@pytest.mark.parametrize("causal_pairs", [True, False], ids=["pairs", "scan"])
@pytest.mark.parametrize("S,chunk", [(256, 64), (150, 50), (96, 96)])
def test_chunked_causal_attention_matches_jax(causal_pairs, S, chunk):
    rng = np.random.default_rng(S + chunk)
    q, k, v = (_normal(rng, 2, h, S, 16) for h in (4, 2, 2))
    want = jlayers.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), chunk=chunk,
                                            causal_pairs=causal_pairs)
    got = tlayers.chunked_causal_attention(_t(q), _t(k), _t(v), chunk=chunk,
                                           causal_pairs=causal_pairs)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=1e-5)
    for n in (S, 4096 + 256, 4000, 511):
        assert tlayers.attn_chunk(n) == j_attn_chunk(n)


@pytest.mark.parametrize("S", [192, 1031])
def test_whole_prompt_causal_attention_of_both_backends(S):
    """A whole prompt (no offset, keys ``[0, Sq)`` of a longer buffer): the
    plain backend runs JAX's chunked form at JAX's chunk (192: one chunk of
    192); a length whose chunk would be under 64 (1031, a prime: chunk 1)
    takes the masked form instead of ~530k chunk pairs.  Both equal the
    kernel backend's path (the flash plain version on CPU tensors)."""
    rng = np.random.default_rng(S)
    q = _normal(rng, 1, 4, S, 16)
    k, v = _normal(rng, 1, 2, S + 37, 16), _normal(rng, 1, 2, S + 37, 16)
    plain = get_backend("reference").causal_attention(_t(q), _t(k), _t(v))
    kernel = get_backend("cuda").causal_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(plain.numpy(), kernel.numpy(), atol=1e-5)
    if S == 192:
        want = jlayers.chunked_causal_attention(
            jnp.asarray(q), jnp.asarray(k[:, :, :S]), jnp.asarray(v[:, :, :S]),
            chunk=j_attn_chunk(S))
        np.testing.assert_allclose(np.asarray(want), plain.numpy(), atol=1e-5)


# -- the flash kernel's plain version with an offset ----------------------------------


def _jax_masked_chunk(q, k, v, offset):
    """JAX's dense ``prefill_chunk`` attention (``repro.models.transformer``):
    chunk queries at ``offset + i`` over the slot's rows, rows past the
    query's position masked; q ``[Hq, C, D]``, k/v ``[n_kv, S, D]``."""
    n_kv, S, D = k.shape
    Hq, C, _ = q.shape
    g = Hq // n_kv
    rel = jnp.arange(C)
    qf = q.reshape(n_kv, g, C, D)
    logits = jnp.einsum("hgcd,hsd->hgcs", qf, k) / jnp.sqrt(jnp.float32(D))
    mask = jnp.arange(S)[None, :] <= (offset + rel)[:, None]
    logits = jnp.where(mask[None, None], logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1)
    return jnp.einsum("hgcs,hsd->hgcd", probs, v).reshape(Hq, C, D)


@pytest.mark.parametrize("offset", OFFSETS)
def test_flash_plain_with_offset_matches_jax_masked_chunk(offset):
    """A chunk of 37 queries at ``offset`` over the keys written so far
    (``k_len = offset + 37``) of a 320-row cache row whose later rows hold
    stale values; through the kernel's wrapper (plain on CPU tensors)."""
    rng = np.random.default_rng(offset)
    C, S = 37, 320
    q, k, v = _normal(rng, 6, C, 16), _normal(rng, 2, S, 16), _normal(rng, 2, S, 16)
    want = _jax_masked_chunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), offset)
    calls = fa.plain_calls
    got = fa.flash_attention(_t(q)[None], _t(k)[None], _t(v)[None], True, offset,
                             offset + C)
    assert fa.plain_calls == calls + 1 and fa.launches == 0
    np.testing.assert_allclose(np.asarray(want), got[0].numpy(), atol=1e-5)


@pytest.mark.parametrize("offset", OFFSETS)
def test_flash_plain_with_offset_matches_jax_dense_backend(offset):
    """Ragged live lengths per sequence (one ends inside the chunk, so its
    later queries see only its live keys), through the flash wrapper and
    the port's ``"dense"`` backend, against JAX's
    ``DenseBackend.prefill_attention``."""
    rng = np.random.default_rng(100 + offset)
    C, S = 64, 336
    q, k, v = _normal(rng, 2, 8, C, 16), _normal(rng, 2, 2, S, 16), _normal(rng, 2, 2, S, 16)
    n_valid = np.asarray([offset + C, offset + 5], np.int32)
    want, _ = jax_backend("dense").prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None,
        n_valid=jnp.asarray(n_valid), chunk_offset=offset)
    got = fa.flash_attention(_t(q), _t(k), _t(v), True, offset, _t(n_valid))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=1e-5)
    paged = [_t(x).reshape(2, 2, S // 16, 16, 16) for x in (k, v)]
    out, none = get_backend("dense").prefill_attention(
        _t(q), *paged, None, None, None, n_valid=_t(n_valid), chunk_offset=offset)
    assert none is None
    np.testing.assert_allclose(np.asarray(want), out.numpy(), atol=1e-5)


def test_flash_plain_without_offset_is_unchanged():
    """The TPU kernel's contract (offset 0, every key live) is the
    special case: the same output as with ``k_len = S`` given."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(_normal(rng, 1, h, 128, 16)) for h in (4, 2, 2))
    for causal in (True, False):
        a = fa.flash_attention(q, k, v, causal)
        b = fa.flash_attention(q, k, v, causal, 0, 128)
        assert torch.equal(a, b)


# -- backends at full budget -------------------------------------------------------

B, N_KV, G, S, D = 2, 4, 2, 2048, 64
BLOCK_SIZES = (16, 32, 64, 32)


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return (_normal(rng, B, N_KV * G, D), _normal(rng, B, N_KV, S, D),
            _normal(rng, B, N_KV, S, D))


@pytest.mark.parametrize("quant", ["none", "int8_asym", "int4_asym"])
def test_backends_match_dense_at_full_budget(quant):
    """Every sparse backend of the port equals its ``"dense"`` backend when
    the budget covers the context (the grid and tolerances of
    ``tests/test_backends.py``); ``"dense"`` equals JAX's, and its plain
    twin (the oracle ``dense_decode_attention``) the kernel path's plain
    versions."""
    q, k, v = _qkv(seed=1)
    lay = t_layout_for(BLOCK_SIZES, S, 16, S)
    la = t_as_arrays(lay)
    sparse = TSparse(token_budget=S, quant=quant)
    tq, tk, tv = _t(q), _t(k), _t(v)
    calls = pa.plain_calls
    out_d, tbl, vld = get_backend("dense").decode(tq, tk, tv, None, la, sparse)
    assert tbl is None and vld is None and pa.plain_calls == calls + 1
    want = jax_backend("dense").decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       None, None, None)[0]
    np.testing.assert_allclose(out_d.numpy(), np.asarray(want), atol=1e-5)
    oracle = DenseBackend(plain=True).decode(tq, tk, tv, None, la, sparse)[0]
    np.testing.assert_allclose(out_d.numpy(), oracle.numpy(), atol=1e-5)
    sl = torch.full((B,), S, dtype=torch.int32)
    for name, fused in (("reference", False), ("cuda", False), ("cuda", True)):
        be = get_backend(name)
        store = be.build_store(tk, lay, "quest", quant=quant)
        sp = dataclasses.replace(sparse, fused_decode=fused)
        out = be.decode(tq, tk, tv, store, la, sp, sl)[0]
        np.testing.assert_allclose(out.numpy(), out_d.numpy(), atol=2e-5, rtol=1e-4)


def test_dense_backend_ragged_decode_matches_jax():
    """Ragged live lengths, paged K/V; the identity page table's invalid
    pages and the positions past the length are never attended."""
    q, k, v = _qkv(seed=2)
    sl = np.asarray([S - 5, 333], np.int32)
    la = t_as_arrays(t_layout_for(BLOCK_SIZES, S, 16, 512))
    sparse = TSparse(token_budget=512)
    paged = [_t(x).reshape(B, N_KV, S // 16, 16, D) for x in (k, v)]
    got = get_backend("dense").decode(_t(q), *paged, None, la, sparse, _t(sl))[0]
    want = jax_backend("dense").decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       None, None, None, seq_len=jnp.asarray(sl))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    table, valid = get_backend("cuda").full_page_table(paged[0], _t(sl))
    assert table.shape == valid.shape == (B, N_KV, S // 16)
    assert torch.equal(table[1, 3], torch.arange(S // 16, dtype=torch.int32))
    assert valid[1].sum(-1).tolist() == [-(-333 // 16)] * N_KV
    assert get_backend("reference").full_page_table(paged[0], _t(sl)) is None


# -- the model ----------------------------------------------------------------------

MAX_CTX = 512
#: under 2 x the budget (plan inactive), and not a multiple of the page size
INACTIVE_CTX = 200
BLOCKS = ((16, 32), (64, 16))
SPARSE = dict(token_budget=128, block_sizes=BLOCKS, prefill_block_q=64)
#: (port backend, fused_decode, JAX backend, max_context)
CASES = {
    "default-fused": ("cuda", True, "reference", MAX_CTX),
    "default-staged": ("cuda", False, "reference", MAX_CTX),
    "default-reference": ("reference", False, "reference", MAX_CTX),
    "inactive": ("cuda", False, "reference", INACTIVE_CTX),
    "inactive-reference": ("reference", False, "reference", INACTIVE_CTX),
    "dense": ("dense", False, "dense", MAX_CTX),
}


def _cfgs(case, arch="llama3.2-3b", sparse_prefill=False):
    t_backend, fused, j_backend, _ = CASES[case]
    jb, tb = j_smoke(j_get_config(arch)), t_smoke(t_get_config(arch))
    kw = dict(SPARSE, sparse_prefill=sparse_prefill)
    jcfg = dataclasses.replace(jb, sparse=dataclasses.replace(
        jb.sparse, backend=j_backend, **kw))
    tcfg = dataclasses.replace(tb, sparse=dataclasses.replace(
        tb.sparse, backend=t_backend, fused_decode=fused, **kw))
    return jcfg, tcfg


def _models(case, **kw):
    jcfg, tcfg = _cfgs(case, **kw)
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jm, params, tm


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, n)).astype(np.int32)


def _decode_both(jm, params, jc, tm, tc, jl, steps):
    tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32).reshape(-1)
    for _ in range(steps):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok.astype(np.int64)))
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        assert np.array_equal(tok, tl.argmax(-1).numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    jm, params, tm = _models(case)
    max_ctx = CASES[case][3]
    tokens = _tokens(150)
    jl, jc = jm.prefill(params, jnp.asarray(tokens), max_context=max_ctx)
    tl, tc = tm.prefill(torch.from_numpy(tokens), max_context=max_ctx)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
    active = tm.use_sparse(max_ctx)
    assert active == (max_ctx == MAX_CTX)
    e = tc["layers"][0]
    assert ("codes" in e) == active and "pcodes" not in e
    assert e["k"].shape[2] == (max_ctx // 16 if active else -(-max_ctx // 16))
    _decode_both(jm, params, jc, tm, tc, jl, steps=4)


def test_dense_backend_with_sparse_prefill_matches_jax():
    """The ``"dense"`` backend under ``sparse_prefill``: the model takes the
    sparse-prefill branch (score segment built), and the backend's
    ``prefill_attention`` attends every causal key."""
    jm, params, tm = _models("dense", sparse_prefill=True)
    tokens = _tokens(192, seed=3)
    jl, jc = jm.prefill(params, jnp.asarray(tokens), max_context=MAX_CTX)
    tl, tc = tm.prefill(torch.from_numpy(tokens), max_context=MAX_CTX)
    assert "pcodes" in tc["layers"][0]
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
    _decode_both(jm, params, jc, tm, tc, jl, steps=2)


#: chunked against single-shot K, f32 (see the test)
CHUNK_K_ATOL = 5e-6
#: chunk buffers of 64 at offsets that are not query-block aligned
CHUNKS = ((0, 50), (50, 64), (114, 13), (127, 64), (191, 9))


def _port_chunked(tm, tokens, max_ctx):
    cache = tm.init_cache(1, max_ctx)
    last = None
    for off, n in CHUNKS:
        buf = np.zeros((64,), np.int64)
        buf[:n] = tokens[0, off:off + n]
        last, cache = tm.prefill_chunk(cache, 0, buf, off, n)
    return last, cache


@pytest.mark.parametrize("case", ["default-fused", "inactive", "dense"])
def test_chunked_dense_prefill_matches_single_shot_and_jax(case):
    jm, params, tm = _models(case)
    max_ctx = CASES[case][3]
    n = sum(CHUNKS[-1])
    tokens = _tokens(n, seed=2)
    single, cs = tm.prefill(torch.from_numpy(tokens), max_context=max_ctx)
    last, cc = _port_chunked(tm, tokens, max_ctx)
    np.testing.assert_allclose(last.numpy(), single[0].numpy(), atol=1e-5)
    # K of the chunks against K of the whole prompt: the CPU BLAS blocks a
    # 64-row projection otherwise than a 264-row one, so even layer 0's K
    # (a per-row projection of equal inputs; no attention) differs by up to
    # 2.4e-7, and layer 1 adds that of its attention (1.24e-6 seen).  The
    # bound is the f32 rounding a two-layer stack accumulates, still 20x
    # under the JAX comparison's ATOL
    for a, b in zip(cc["layers"], cs["layers"]):
        np.testing.assert_allclose(a["k"].numpy(), b["k"].numpy(), atol=CHUNK_K_ATOL)
    tm.refresh_slot_store(cc, 0)
    assert ("codes" in cc["layers"][0]) == tm.use_sparse(max_ctx)

    jcache = jm.init_cache(1, max_ctx)
    for off, k in CHUNKS:
        buf = np.zeros((64,), np.int32)
        buf[:k] = tokens[0, off:off + k]
        jl, jcache = jm.prefill_chunk(params, jcache, jnp.int32(0), jnp.asarray(buf),
                                      jnp.int32(off), jnp.int32(k))
    jcache = jm.refresh_slot_store(jcache, jnp.int32(0))
    np.testing.assert_allclose(np.asarray(jl), last.numpy(), atol=ATOL)
    jcache = dict(jcache)
    jcache["seq_len"] = jnp.full((1,), n, jnp.int32)
    cc["seq_len"].fill_(n)
    _decode_both(jm, params, jcache, tm, cc, jl[None], steps=3)
