"""Local (sliding-window) attention in the port against JAX on the CPU, at
recurrentgemma-9b's smoke width (window W 64, 4 query heads of 16 on one
kv head), float32:

- ``layers.chunked_causal_attention(..., window=W)`` against JAX's at
  sequence lengths W - 1, W and 2W + 3 (chunk ``attn_chunk(S)``, as the
  models call it) and groups of 1, 4 and 16 query heads a kv head, within
  1e-5;
- a stack of two ``"local_attn"`` layers: ``prefill`` at prompts of W - 1,
  W and 2W + 3 tokens (logits within 1e-4, the ring buffers' K / V equal
  to JAX's within 1e-5, the rows of the last ``min(W, S)`` positions at
  slot ``position % W``), then ``decode_step`` for W + 5 tokens, so that
  every prompt's ring wraps at least once: logits within 1e-4, greedy
  tokens identical, the ring buffers as JAX's after the last step;
- ``layers.ring_valid`` against a direct count of the live positions.

About 20 s in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Transformer as JTransformer
from repro.models import layers as jlayers

from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tlayers

from test_torch_dense_family import _one_thread  # noqa: F401
from test_torch_rglru import cfgs

W = 64
LENS = (W - 1, W, 2 * W + 3)


@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("S", LENS)
def test_windowed_attention_matches_jax(S, g):
    rng = np.random.default_rng(S * 10 + g)
    hkv, D = 2, 16
    q = rng.standard_normal((2, hkv * g, S, D)).astype(np.float32)
    k = rng.standard_normal((2, hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((2, hkv, S, D)).astype(np.float32)
    chunk = tlayers.attn_chunk(S)
    want = jlayers.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            chunk=chunk, window=W)
    got = tlayers.chunked_causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), chunk=chunk, window=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _models():
    jc, tc = cfgs("recurrentgemma-9b", "float32", layer_pattern=("local_attn",),
                  n_layers=2)
    params = JTransformer(jc).init(jax.random.PRNGKey(7))
    return JTransformer(jc), params, params_from_jax(jax.tree.map(np.asarray, params),
                                                     tc, device="cpu")


def _rings(jcache, tcache):
    for l, e in enumerate(tcache["layers"]):
        je = jcache["pos0"]
        for name in ("k", "v"):
            np.testing.assert_allclose(e[name].numpy(), np.asarray(je[name][l]),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", LENS)
def test_ring_buffer_prefill_and_decode_across_the_wrap_match_jax(S):
    jm, params, tm = _models()
    assert tm.cfg.local_window == W and tm.cfg.n_kv_heads == 1
    max_ctx = S + W + 8
    toks = np.random.default_rng(S).integers(0, 256, (2, S)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="max_context")(
        params, jnp.asarray(toks), max_context=max_ctx)
    j_decode = jax.jit(jm.decode_step)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_context=max_ctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    assert tc["layers"][0]["k"].shape == (2, 1, W, 16)
    _rings(jc, tc)
    # the ring holds the last min(W, S) positions at slot position % W
    L = min(W, S)
    h = tlayers.rms_norm(tm.embed[torch.from_numpy(toks).long()], tm.layers[0].norm1,
                         tm.cfg.norm_eps)
    _, k, _ = tlayers.qkv_project(tm.layers[0], h, tm.cfg, torch.arange(S)[None])
    pos = torch.arange(S - L, S)
    torch.testing.assert_close(tc["layers"][0]["k"][:, :, pos % W], k[:, pos].transpose(1, 2))
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    assert np.array_equal(tok, tl.argmax(-1).numpy())
    for _ in range(W + 5):
        jl, jc = j_decode(params, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok.astype(np.int64)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        assert np.array_equal(tok, tl.argmax(-1).numpy())
    assert int(tc["seq_len"][0]) == S + W + 5
    _rings(jc, tc)


def test_ring_valid_counts_the_live_positions():
    seq = torch.tensor([0, 5, W - 1, W, W + 7, 3 * W + 1])
    got = tlayers.ring_valid(seq, W)
    for b, n in enumerate(seq.tolist()):
        live = {p % W for p in range(max(0, n - W + 1), n + 1)}
        assert set(torch.nonzero(got[b])[:, 0].tolist()) == live
