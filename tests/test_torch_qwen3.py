"""qwen3-8b, the second config of the port's main path, against the JAX
package on the CPU.

qwen3-8b is the first config with an untied ``lm_head`` and GQA group 4 at
full width (32 / 8 heads, head_dim 128).  Its smoke variant (the JAX
reduction: 2 layers, d_model 64, 4 / 2 heads, vocab 256, float32) runs with
weights carried from JAX's init by ``params_from_jax``:

- the configs agree with JAX's, full and smoke;
- the untied head travels bit-exactly (bf16) and is the one ``unembed``
  reads;
- logits within 1e-4 (f32) and greedy tokens identical to JAX for the
  default configuration (dense prefill; fused and staged sparse decode)
  and for sparse prefill, through the ``"cuda"`` backend's plain versions;
- engine token streams identical to JAX's (the default configuration and
  sparse prefill, with a prefix-cache hit).
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

from test_torch_dense_engine import check_streams, serve_both

ARCH = "qwen3-8b"
MAX_CTX = 512
ATOL = 1e-4
SPARSE = dict(token_budget=128, block_sizes=((16, 32), (64, 16)), prefill_block_q=64)
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
          "resolved_head_dim", "rope_theta", "norm_eps", "tie_embeddings",
          "qkv_bias", "activation", "dtype", "layer_pattern")


def test_qwen3_configs_agree_with_jax():
    full_j, full_t = j_get_config(ARCH), t_get_config(ARCH)
    for f in FIELDS:
        assert getattr(full_j, f) == getattr(full_t, f), f
    assert (full_t.n_layers, full_t.d_model, full_t.n_heads, full_t.n_kv_heads,
            full_t.resolved_head_dim, full_t.d_ff, full_t.vocab_size) == (
        36, 4096, 32, 8, 128, 12288, 151936)
    assert not full_t.tie_embeddings and full_t.rope_theta == 1e6
    smoke_j, smoke_t = j_smoke(full_j), t_smoke(full_t)
    for f in FIELDS:
        assert getattr(smoke_j, f) == getattr(smoke_t, f), f
    assert smoke_t.sparse.token_budget == smoke_j.sparse.token_budget == 64


def _cfgs(dtype="float32", fused_decode=True, sparse_prefill=False):
    jb, tb = j_smoke(j_get_config(ARCH)), t_smoke(t_get_config(ARCH))
    kw = dict(SPARSE, sparse_prefill=sparse_prefill)
    jcfg = dataclasses.replace(jb, dtype=dtype, sparse=dataclasses.replace(
        jb.sparse, backend="reference", **kw))
    tcfg = dataclasses.replace(tb, dtype=dtype, sparse=dataclasses.replace(
        tb.sparse, backend="cuda", fused_decode=fused_decode, **kw))
    return jcfg, tcfg


def test_untied_head_round_trips_bit_exact():
    jcfg, tcfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, JTransformer(jcfg).init(jax.random.PRNGKey(2)))
    tm = params_from_jax(tree, tcfg, device="cpu")
    assert tm.lm_head is not None and tm.lm_head.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(tm.lm_head),
                                  np.asarray(tree["lm_head"]).view(np.uint16))
    assert not np.array_equal(np.asarray(tree["lm_head"]), np.asarray(tree["embed"]).T)
    h = torch.ones((1, tcfg.d_model), dtype=torch.bfloat16)
    assert torch.equal(tm.unembed(h), torch.matmul(h, tm.lm_head))


@pytest.mark.parametrize("fused,sparse_prefill", [(True, False), (False, False),
                                                  (True, True)],
                         ids=["default-fused", "default-staged", "sparse-prefill"])
def test_qwen3_prefill_and_decode_match_jax(fused, sparse_prefill):
    jcfg, tcfg = _cfgs(fused_decode=fused, sparse_prefill=sparse_prefill)
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    tokens = np.random.default_rng(4).integers(0, 256, (1, 320)).astype(np.int32)
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


@pytest.mark.parametrize("sparse_prefill", [False, True], ids=["default", "sparse-prefill"])
def test_qwen3_engine_token_streams_match_jax(sparse_prefill, monkeypatch):
    import test_torch_dense_engine as dense_engine

    monkeypatch.setitem(dense_engine.SPARSE, "sparse_prefill", sparse_prefill)
    jeng, teng, jout, tout = serve_both(ARCH, "cuda", True, "reference", {}, 5)
    snap = check_streams(jeng, teng, jout, tout, 5)
    # sparse prefill aligns the reused prefix to the 64-token query block
    assert snap["prefix_hit_tokens"] == (128 if sparse_prefill else 144)
