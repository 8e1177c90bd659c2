"""Griffin's RG-LRU block in the port (``repro_torch.models.rglru``) against
JAX's (``repro.models.rglru``) on the CPU, at recurrentgemma-9b's smoke
width (d 64), on the same weights (JAX's ``init_rglru``) and inputs:

- ``rglru_block`` over 5 and 300 tokens (the port's log-depth scan against
  JAX's ``associative_scan``) and its final state against JAX's
  ``Transformer._rglru_final_state``;
- ``rglru_decode`` from a random state;
- a prompt shorter than the convolution's tail (2 tokens): the port's
  zero-padded tail, continued by ``rglru_decode``, equals the block over 3
  tokens (JAX's final state needs 3).

f32: within atol 3e-5 and rtol 1e-3.  bf16: both frameworks round every
stage to bf16 and evaluate the nonlinearities differently (XLA's bf16
``logistic`` lands up to two bf16 steps from the correctly rounded value,
where torch's rounds the f32 result), so their outputs part by about the
distance each has from the same function in f32 (about 1% relative L2 a
row over 300 tokens).  Each row is held to that: the port's relative L2
distance to JAX's f32 run on the same bf16 weights at most one bf16 step
(2^-7) or ``BF16_SLACK`` times JAX's own worst row, whichever is larger,
and its distance to JAX's bf16 run at most twice that.  The conv tail
(one matmul, rounded once) is held to one bf16 step per element.

About 25 s in one process.
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
from repro.models import rglru as jrglru

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import layer_keys, to_torch
from repro_torch.models import rglru as trglru
from repro_torch.models.layers import DecoderLayer

from test_torch_dense_family import _one_thread  # noqa: F401

ARCH = "recurrentgemma-9b"
ATOL, RTOL = 3e-5, 1e-3
#: the port's bf16 rows may be this much further from the f32 function than
#: JAX's bf16 rows are
BF16_SLACK = 1.25


def cfgs(arch, dtype, **kw):
    jc = dataclasses.replace(j_smoke(j_get_config(arch)), dtype=dtype, **kw)
    tc = dataclasses.replace(t_smoke(t_get_config(arch)), dtype=dtype, **kw)
    return jc, tc


def mixing_layer(tcfg, kind, sub, tree):
    """A port layer of ``kind`` whose mixing weights are JAX's ``tree``
    (the layer's ``sub`` entry: ``"rec"`` or ``"tmix"``); the rest stay
    unset."""
    layer = DecoderLayer(tcfg, getattr(torch, tcfg.dtype), "cpu", kind)
    keys = layer_keys(tcfg, kind)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            path = keys[name]
            if path[0] != sub:
                continue
            node = {sub: tree}
            for key in path:
                node = node[key]
            p.copy_(to_torch(np.asarray(node)))
    return layer


def f32_tree(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def np32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def row_rel(a, b):
    a, b = np32(a), np32(b)
    return np.linalg.norm(a - b, axis=-1) / np.maximum(np.linalg.norm(b, axis=-1), 1e-30)


def check(port, jax_out, dtype, ref=None):
    """f32: allclose; bf16: the row rule of the module docstring against
    JAX's bf16 output and ``ref``, its f32 run."""
    if dtype == "float32":
        np.testing.assert_allclose(np32(port), np32(jax_out), atol=ATOL, rtol=RTOL)
        return
    limit = max(2.0 ** -7, BF16_SLACK * row_rel(jax_out, ref).max())
    assert row_rel(port, ref).max() <= limit
    assert row_rel(port, jax_out).max() <= 2 * limit


def bf16_steps(a, b):
    """|a - b| in bf16 steps of the larger magnitude, per element."""
    a, b = np32(a), np32(b)
    m = np.maximum(np.abs(a), np.abs(b))
    return np.abs(a - b) / 2.0 ** (np.floor(np.log2(np.maximum(m, 1e-30))) - 7)


def _setup(dtype, seed=1):
    jc, tc = cfgs(ARCH, dtype)
    p = jrglru.init_rglru(jax.random.PRNGKey(seed), jc)
    return jc, tc, p, mixing_layer(tc, "rglru", "rec", p)


@pytest.mark.parametrize("S", [5, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_block_and_final_state_match_jax(dtype, S):
    jc, tc, p, layer = _setup(dtype)
    x = jax.random.normal(jax.random.PRNGKey(2), (2, S, jc.d_model)).astype(dtype)
    out, (h, tail) = trglru.rglru_block(layer, to_torch(np.asarray(x)), tc)
    want = jrglru.rglru_block(p, x, jc)
    wh, wtail = JTransformer(jc)._rglru_final_state(p, x)
    ref = ref_h = None
    if dtype == "bfloat16":
        jcf = dataclasses.replace(jc, dtype="float32")
        ref = jrglru.rglru_block(f32_tree(p), x.astype(jnp.float32), jcf)
        ref_h = JTransformer(jcf)._rglru_final_state(f32_tree(p), x.astype(jnp.float32))[0]
    assert out.dtype == getattr(torch, dtype) and h.dtype == torch.float32
    check(out, want, dtype, ref)
    check(h, wh, dtype, ref_h)
    if dtype == "float32":
        np.testing.assert_allclose(np32(tail), np32(wtail), atol=ATOL, rtol=RTOL)
    else:
        assert bf16_steps(tail, wtail).max() <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_decode_matches_jax(dtype):
    jc, tc, p, layer = _setup(dtype, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    x = jax.random.normal(keys[0], (3, 1, jc.d_model)).astype(dtype)
    h0 = jax.random.normal(keys[1], (3, jc.d_model), jnp.float32)
    c0 = jax.random.normal(keys[2], (3, trglru.CONV_K - 1, jc.d_model)).astype(dtype)
    out, (h, conv) = trglru.rglru_decode(
        layer, to_torch(np.asarray(x)), (to_torch(np.asarray(h0)), to_torch(np.asarray(c0))), tc)
    wout, (wh, wconv) = jrglru.rglru_decode(p, x, (h0, c0), jc)
    ref = ref_h = None
    if dtype == "bfloat16":
        jcf = dataclasses.replace(jc, dtype="float32")
        ref, (ref_h, _) = jrglru.rglru_decode(
            f32_tree(p), x.astype(jnp.float32), (h0, c0.astype(jnp.float32)), jcf)
    assert out.shape == (3, 1, jc.d_model)
    check(out, wout, dtype, ref)
    check(h, wh, dtype, ref_h)
    np.testing.assert_array_equal(np32(conv), np32(wconv))


def test_short_prompt_tail_is_zero_padded():
    """Two tokens leave a tail of (0, u_0, u_1); decoding the third from it
    gives the block's third row and its state."""
    jc, tc, p, layer = _setup("float32", seed=5)
    x = torch.randn((2, 3, jc.d_model), generator=torch.Generator().manual_seed(0))
    full, (h_full, tail_full) = trglru.rglru_block(layer, x, tc)
    _, (h2, tail2) = trglru.rglru_block(layer, x[:, :2], tc)
    assert torch.equal(tail2[:, 0], torch.zeros_like(tail2[:, 0]))
    out, (h3, tail3) = trglru.rglru_decode(layer, x[:, 2:], (h2, tail2), tc)
    torch.testing.assert_close(out[:, 0], full[:, 2], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(h3, h_full, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(tail3, tail_full, atol=ATOL, rtol=RTOL)
