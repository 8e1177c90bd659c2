"""Model-level parity of the PyTorch port with the JAX package, on the CPU.

The smoke variant of llama3.2-3b in float32, with fixed non-uniform
per-(layer, head) block sizes and max_context 512 so the sparse plan is
active; the port's weights are the JAX init carried across by
``params_from_jax``.  JAX runs its ``"reference"`` backend (plain sparse
prefill, staged decode); the port runs its ``"cuda"`` backend on CPU
tensors (the kernels' plain versions), once with ``fused_decode`` (the
fused decode kernel's plain version) and once without (the staged decode:
scoring, stable-sort selection, paged attention).

Tolerance: logits within 1e-4 absolute (float32; the two frameworks round
matmuls, exp and rsqrt differently at the last bit).  Greedy tokens must be
identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.models import Transformer as JTransformer

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import params_from_jax, to_numpy

MAX_CTX = 512
BLOCKS = ((16, 32), (64, 16))
ATOL = 1e-4
SPARSE = dict(token_budget=128, block_sizes=BLOCKS, sparse_prefill=True,
              prefill_block_q=64)


def stacked_cache(cache, name):
    """One cache entry over all layers, ``[n_layers, ...]``."""
    return torch.stack([e[name] for e in cache["layers"]])


def _cfgs(dtype="float32", fused_decode=False):
    jb, tb = j_smoke(j_get_config("llama3.2-3b")), t_smoke(t_get_config("llama3.2-3b"))
    jcfg = dataclasses.replace(
        jb, dtype=dtype,
        sparse=dataclasses.replace(jb.sparse, backend="reference", **SPARSE))
    tcfg = dataclasses.replace(
        tb, dtype=dtype, sparse=dataclasses.replace(
            tb.sparse, backend="cuda", fused_decode=fused_decode, **SPARSE))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "staged"])
def models(request):
    jcfg, tcfg = _cfgs(fused_decode=request.param)
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tm = params_from_jax(tree, tcfg, device="cpu")
    return jm, params, tm


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, n)).astype(np.int32)


def test_configs_agree():
    jcfg, tcfg = _cfgs()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "resolved_head_dim", "rope_theta", "norm_eps",
              "tie_embeddings", "dtype"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    full_j, full_t = j_get_config("llama3.2-3b"), t_get_config("llama3.2-3b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "resolved_head_dim", "tie_embeddings", "dtype"):
        assert getattr(full_j, f) == getattr(full_t, f), f


def test_prefill_and_decode_match_jax(models):
    jm, params, tm = models
    tokens = _tokens(448)
    jl, jc = jm.prefill(params, jnp.asarray(tokens), max_context=MAX_CTX)
    tl, tc = tm.prefill(torch.from_numpy(tokens), max_context=MAX_CTX)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
    tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    for _ in range(4):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok.astype(np.int64)))
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        assert np.array_equal(tok, tl.argmax(-1).numpy())


CHUNKS = ((0, 128), (128, 64), (192, 128), (320, 128))


def _port_chunked(tm, tokens):
    cache = tm.init_cache(1, MAX_CTX)
    last = None
    for off, n in CHUNKS:
        buf = np.zeros((128,), np.int64)
        buf[:n] = tokens[0, off:off + n]
        last, cache = tm.prefill_chunk(cache, 0, buf, off, n)
    return last, cache


def test_chunked_prefill_bitwise_equals_single_shot(models):
    _, _, tm = models
    tokens = _tokens(448, seed=1)
    single, cs = tm.prefill(torch.from_numpy(tokens), max_context=MAX_CTX)
    last, cc = _port_chunked(tm, tokens)
    assert torch.equal(last, single[0])
    # score rows of blocks past the prompt are never scored; their affine
    # params differ by design (stale vs built from zero keys)
    for name in ("k", "v", "pcodes"):
        assert torch.equal(stacked_cache(cc, name), stacked_cache(cs, name)), name
    tm.refresh_slot_store(cc, 0)
    for name in ("codes", "scale", "zero"):
        assert torch.equal(stacked_cache(cc, name), stacked_cache(cs, name)), name


def test_chunked_prefill_and_refresh_match_jax(models):
    jm, params, tm = models
    tokens = _tokens(448, seed=2)
    jcache = jm.init_cache(1, MAX_CTX)
    for off, n in CHUNKS:
        buf = np.zeros((128,), np.int32)
        buf[:n] = tokens[0, off:off + n]
        jl, jcache = jm.prefill_chunk(params, jcache, jnp.int32(0),
                                      jnp.asarray(buf), jnp.int32(off), jnp.int32(n))
    jcache = jm.refresh_slot_store(jcache, jnp.int32(0))
    tl, tc = _port_chunked(tm, tokens)
    tm.refresh_slot_store(tc, 0)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
    jcache = dict(jcache)
    jcache["seq_len"] = jnp.full((1,), 448, jnp.int32)
    tc["seq_len"].fill_(448)
    tok = np.asarray([int(jnp.argmax(jl))], np.int32)
    assert tok[0] == int(tl.argmax())
    for _ in range(3):
        jd, jcache = jm.decode_step(params, jcache, jnp.asarray(tok))
        td, tc = tm.decode_step(tc, torch.from_numpy(tok.astype(np.int64)))
        np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=ATOL)
        tok = np.asarray(jnp.argmax(jd, axis=-1), np.int32)
        assert np.array_equal(tok, td.argmax(-1).numpy())


def test_bf16_weights_round_trip_bit_exact():
    jcfg, tcfg = _cfgs("bfloat16")
    params = JTransformer(jcfg).init(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, params)
    tm = params_from_jax(tree, tcfg, device="cpu")
    assert tm.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        to_numpy(tm.embed), np.asarray(tree["embed"]).view(np.uint16)
    )
    for l, layer in enumerate(tm.layers):
        np.testing.assert_array_equal(
            to_numpy(layer.wq),
            np.asarray(tree["cycles"]["pos0"]["attn"]["wq"]["w"])[l].view(np.uint16),
        )
        np.testing.assert_array_equal(
            to_numpy(layer.down),
            np.asarray(tree["cycles"]["pos0"]["ffn"]["down"]["w"])[l].view(np.uint16),
        )
