"""RWKV-6 time mixing in the port (``repro_torch.models.rwkv6``) against
JAX's (``repro.models.rwkv6``) on the CPU, at rwkv6-3b's smoke width (d
64) with ``rwkv_head_dim`` 64 and 16 (1 and 4 heads), on the same weights
(JAX's ``init_rwkv``, its constant ``mu``, ``u`` and ``w_bias`` replaced by
random values so that every channel mixes differently) and inputs:

- ``rwkv_time_mix`` over 5 and 300 tokens (the port's chunked recurrence
  against JAX's ``lax.scan`` of ``_step``; 300 is no multiple of the
  chunk) and its final state ``(S, x_prev)`` against JAX's
  ``Transformer._rwkv_final_state``;
- ``rwkv_decode`` from a random state;
- the chunked recurrence at chunk 1 (a plain loop over time) equals the
  default chunk.

Tolerances as ``test_torch_rglru``: f32 within atol 3e-5 and rtol 1e-3;
bf16 by its row rule (x_prev bitwise: it is the last input row).

About 25 s in one process.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Transformer as JTransformer
from repro.models import rwkv6 as jrwkv

from repro_torch.convert import to_torch
from repro_torch.models import rwkv6 as trwkv

from test_torch_dense_family import _one_thread  # noqa: F401
from test_torch_rglru import ATOL, RTOL, cfgs, check, f32_tree, mixing_layer, np32

ARCH = "rwkv6-3b"


def _setup(dtype, N, seed=1):
    jc, tc = cfgs(ARCH, dtype, rwkv_head_dim=N)
    d = jc.d_model
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), 3)
    p = dict(jrwkv.init_rwkv(jax.random.PRNGKey(seed), jc),
             mu=jax.random.uniform(keys[0], (5, d), jnp.float32),
             u=jax.random.normal(keys[1], (d,), jnp.float32),
             w_bias=-2.0 + jax.random.normal(keys[2], (d,), jnp.float32))
    return jc, tc, p, mixing_layer(tc, "rwkv", "tmix", p)


def _f32(jc):
    return dataclasses.replace(jc, dtype="float32")


@pytest.mark.parametrize("N", [64, 16], ids=["1-head", "4-heads"])
@pytest.mark.parametrize("S", [5, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_time_mix_and_final_state_match_jax(dtype, S, N):
    jc, tc, p, layer = _setup(dtype, N)
    x = jax.random.normal(jax.random.PRNGKey(2), (2, S, jc.d_model)).astype(dtype)
    out, (S_last, xprev) = trwkv.rwkv_time_mix(layer, to_torch(np.asarray(x)), tc)
    want = jrwkv.rwkv_time_mix(p, x, jc)
    wS, wxprev = JTransformer(jc)._rwkv_final_state(p, x)
    ref = ref_S = None
    if dtype == "bfloat16":
        xf = x.astype(jnp.float32)
        ref = jrwkv.rwkv_time_mix(f32_tree(p), xf, _f32(jc))
        ref_S = JTransformer(_f32(jc))._rwkv_final_state(f32_tree(p), xf)[0]
    H = jc.d_model // N
    assert S_last.shape == (2, H, N, N) and S_last.dtype == torch.float32
    check(out, want, dtype, ref)
    check(S_last.flatten(-2), np.asarray(wS).reshape(2, H, N * N), dtype,
          None if ref_S is None else np.asarray(ref_S).reshape(2, H, N * N))
    np.testing.assert_array_equal(np32(xprev), np32(wxprev))


@pytest.mark.parametrize("N", [64, 16], ids=["1-head", "4-heads"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_decode_matches_jax(dtype, N):
    jc, tc, p, layer = _setup(dtype, N, seed=3)
    H = jc.d_model // N
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    x = jax.random.normal(keys[0], (3, 1, jc.d_model)).astype(dtype)
    S0 = jax.random.normal(keys[1], (3, H, N, N), jnp.float32)
    xp0 = jax.random.normal(keys[2], (3, jc.d_model)).astype(dtype)
    out, (S1, xp1) = trwkv.rwkv_decode(
        layer, to_torch(np.asarray(x)), (to_torch(np.asarray(S0)), to_torch(np.asarray(xp0))),
        tc)
    wout, (wS, wxp) = jrwkv.rwkv_decode(p, x, (S0, xp0), jc)
    ref = ref_S = None
    if dtype == "bfloat16":
        ref, (ref_S, _) = jrwkv.rwkv_decode(
            f32_tree(p), x.astype(jnp.float32), (S0, xp0.astype(jnp.float32)), _f32(jc))
        ref_S = np.asarray(ref_S).reshape(3, H, N * N)
    check(out, wout, dtype, ref)
    check(S1.flatten(-2), np.asarray(wS).reshape(3, H, N * N), dtype, ref_S)
    np.testing.assert_array_equal(np32(xp1), np32(wxp))


def test_chunk_of_one_is_the_loop_over_time():
    _, tc, _, layer = _setup("float32", 16, seed=5)
    gen = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn((2, 70, 4, 16), generator=gen) for _ in range(3))
    logw = -torch.exp(torch.randn((2, 70, 4, 16), generator=gen) - 1.0)
    S0 = torch.randn((2, 4, 16, 16), generator=gen)
    o1, S1 = trwkv.wkv_chunked(r, k, v, logw, layer.u, S0, chunk=1)
    oc, Sc = trwkv.wkv_chunked(r, k, v, logw, layer.u, S0)
    torch.testing.assert_close(oc, o1, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(Sc, S1, atol=ATOL, rtol=RTOL)
