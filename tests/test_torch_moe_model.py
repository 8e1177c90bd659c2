"""The MoE family in the port's model, against JAX on the CPU:
granite-moe-3b-a800m (40 experts top-8, SwiGLU, tied embeddings) and
grok-1-314b (8 experts top-2, GeGLU; about 628 GB of bf16 weights, so the
port runs its smoke variant only).

- each config agrees with JAX's field by field (``moe`` and ``family``
  too), full and smoke;
- ``params_from_jax`` carries the router (f32) and the experts' ``[E,
  ...]`` arrays (bf16) bit-exactly;
- at f32, logits within 1e-4 and greedy tokens identical to JAX's for
  ``prefill``, chunked ``prefill_chunk`` (buffers of 64, a padded last
  chunk of 9 live tokens) and three decode steps after each, in the
  repo's default configuration (dense prefill, fused sparse decode) and
  on the ``"dense"`` backend: granite's default at the published
  capacity factor 1.25, where a chunk of 64 tokens has 40 places an
  expert and picks are dropped (the port must group and size every
  chunk's queues by the buffer's 64 tokens, as JAX's call does), the
  other cases at the smoke variant's lossless capacity.  grok-1-314b's
  cases are ``test_torch_moe_model_grok.py`` (a file of their own, so
  that neither file holds a worker long).
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
from repro_torch.convert import layer_keys, params_from_jax, to_numpy
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

from test_torch_dense_family import BLOCK_SIZES, _one_thread  # noqa: F401
from test_torch_qwen3 import FIELDS

GRANITE, GROK = "granite-moe-3b-a800m", "grok-1-314b"
ARCHS = (GRANITE, GROK)
#: (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab, E, K)
FULL = {GRANITE: (32, 1536, 24, 8, 64, 512, 49155, 40, 8),
        GROK: (64, 6144, 48, 8, 128, 32768, 131072, 8, 2)}
MAX_CTX = 512
ATOL = 1e-4
#: (offset, live tokens) of 64-token chunk buffers; the last is padded
CHUNKS = ((0, 64), (64, 64), (128, 50), (178, 64), (242, 9))
#: case -> (arch, port backend, fused decode, JAX backend, capacity factor
#: or None for the smoke variant's lossless one)
CASES = {
    "granite-default": (GRANITE, "cuda", True, "reference", 1.25),
    "granite-dense": (GRANITE, "dense", False, "dense", None),
    "grok-default": (GROK, "cuda", True, "reference", None),
    "grok-dense": (GROK, "dense", False, "dense", None),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree_with_jax(arch):
    full_j, full_t = j_get_config(arch), t_get_config(arch)
    for cj, ct in ((full_j, full_t), (j_smoke(full_j), t_smoke(full_t))):
        for f in FIELDS + ("family", "frontend", "n_prefix_embeddings"):
            assert getattr(cj, f) == getattr(ct, f), f
        assert dataclasses.astuple(cj.moe) == dataclasses.astuple(ct.moe)
    assert (full_t.n_layers, full_t.d_model, full_t.n_heads, full_t.n_kv_heads,
            full_t.resolved_head_dim, full_t.d_ff, full_t.vocab_size,
            full_t.moe.n_experts, full_t.moe.experts_per_token) == FULL[arch]
    assert full_t.family == "moe" and full_t.moe.capacity_factor == 1.25
    smoke = t_smoke(full_t)
    assert smoke.moe.n_experts == 4 and smoke.moe.capacity_factor == 2.0


def _cfgs(case, dtype="float32"):
    arch, t_backend, fused, j_backend, cf = CASES[case]
    jb, tb = j_smoke(j_get_config(arch)), t_smoke(t_get_config(arch))
    kw = dict(token_budget=128, block_sizes=BLOCK_SIZES[tb.n_kv_heads],
              prefill_block_q=64)
    jcfg = dataclasses.replace(jb, dtype=dtype, sparse=dataclasses.replace(
        jb.sparse, backend=j_backend, **kw))
    tcfg = dataclasses.replace(tb, dtype=dtype, sparse=dataclasses.replace(
        tb.sparse, backend=t_backend, fused_decode=fused, **kw))
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
    return jcfg, tcfg


def _models(case, dtype="float32", seed=0):
    jcfg, tcfg = _cfgs(case, dtype)
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jm, params, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bit_exact(arch):
    jm, params, tm = _models(f"{arch.split('-')[0]}-default", dtype="bfloat16", seed=2)
    tree = jax.tree.map(np.asarray, params)
    cyc = tree["cycles"]["pos0"]
    names = set()
    for l, layer in enumerate(tm.layers):
        for name, p in layer.named_parameters():
            node = cyc
            for key in layer_keys(tm.cfg)[name]:
                node = node[key]
            want = np.asarray(node)[l]
            if name == "router":
                assert p.dtype == torch.float32 and want.dtype == np.float32
                np.testing.assert_array_equal(p.numpy(), want)
            else:
                assert p.dtype == torch.bfloat16
                np.testing.assert_array_equal(to_numpy(p), want.view(np.uint16))
            names.add(name)
    E = tm.cfg.moe.n_experts
    assert tm.layers[0].up.shape == (E, tm.cfg.d_model, tm.cfg.d_ff)
    assert tm.layers[0].down.shape == (E, tm.cfg.d_ff, tm.cfg.d_model)
    assert {"router", "up", "gate", "down"} <= names
    assert (tm.lm_head is None) == tm.cfg.tie_embeddings


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, n)).astype(np.int32)


def _decode_both(jm, params, jc, tm, tc, jl, steps=3):
    tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32).reshape(-1)
    for _ in range(steps):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok.astype(np.int64)))
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        assert np.array_equal(tok, tl.argmax(-1).numpy())


@pytest.fixture
def drops(monkeypatch):
    """Count the (token, k) picks the port's MoE FFN drops, by call."""
    seen = []
    orig = tmoe.moe_ffn

    def counting(*args, **kw):
        routing = {}
        y = orig(*args, routing=routing, **kw)
        seen.append(int((~routing["kept"]).sum()))
        return y

    monkeypatch.setattr(tlayers, "moe_ffn", counting)
    return seen


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("granite")])
def test_prefill_chunks_and_decode_match_jax(case, drops):
    check_case(case, drops)


def check_case(case, drops):
    jm, params, tm = _models(case)
    n = sum(CHUNKS[-1])
    tokens = _tokens(n, seed=3)
    # single shot
    jl, jc = jm.prefill(params, jnp.asarray(tokens), max_context=MAX_CTX)
    tl, tc = tm.prefill(torch.from_numpy(tokens), max_context=MAX_CTX)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
    _decode_both(jm, params, jc, tm, tc, jl)
    # chunked, the last chunk padded
    cache, jcache = tm.init_cache(1, MAX_CTX), jm.init_cache(1, MAX_CTX)
    for off, k in CHUNKS:
        buf = np.zeros((64,), np.int32)
        buf[:k] = tokens[0, off:off + k]
        tl, cache = tm.prefill_chunk(cache, 0, buf.astype(np.int64), off, k)
        jl, jcache = jm.prefill_chunk(params, jcache, jnp.int32(0), jnp.asarray(buf),
                                      jnp.int32(off), jnp.int32(k))
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
    tm.refresh_slot_store(cache, 0)
    jcache = dict(jm.refresh_slot_store(jcache, jnp.int32(0)))
    jcache["seq_len"] = jnp.full((1,), n, jnp.int32)
    cache["seq_len"].fill_(n)
    _decode_both(jm, params, jcache, tm, cache, jl[None])
    if CASES[case][4] is None:
        assert not any(drops)
    else:
        # chunks of 64 at 40 places an expert drop picks
        assert sum(drops) > 0
