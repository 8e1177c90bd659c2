"""The JAX package's other dense decoders in the port, against JAX on the
CPU: llama3.1-8b, qwen1.5-4b (QKV bias, MHA), qwen3-32b (GQA group 8),
gemma-7b (GeGLU, head_dim 256, tied embeddings) and nemotron-4-340b
(ReLU^2, no gate; smoke variant only).

- the registry lists JAX's dense decoders, and each config agrees with
  JAX's field by field, full and smoke;
- ``params_from_jax`` carries bf16 weights bit-exactly, the QKV bias and a
  missing gate included;
- ``layers.mlp`` equals JAX's for each of the four activations on the
  same numpy weights (GELU in its tanh form, JAX's ``approximate=True``);
- gemma-7b's smoke variant with its head_dim of 256 restored: at f32,
  logits within 1e-4 and greedy tokens identical to JAX's through the
  ``"cuda"`` backend's plain versions, for the default configuration
  (fused and staged decode) and for sparse prefill
  (``test_torch_dense_family_logits.py`` holds the same for every arch's
  smoke variant).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import smoke_variant as j_smoke
from repro.models import Transformer as JTransformer
from repro.models import layers as jlayers

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_archs as t_list_archs
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import _LAYER_KEYS, params_from_jax, to_numpy
from repro_torch.models import layers as tlayers

from test_torch_qwen3 import FIELDS

ARCHS = ("llama3.1-8b", "qwen1.5-4b", "qwen3-32b", "gemma-7b", "nemotron-4-340b")
#: (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab) at full width
FULL = {
    "llama3.1-8b": (32, 4096, 32, 8, 128, 14336, 128256),
    "qwen1.5-4b": (40, 2560, 20, 20, 128, 6912, 151936),
    "qwen3-32b": (64, 5120, 64, 8, 128, 25600, 151936),
    "gemma-7b": (28, 3072, 16, 16, 256, 24576, 256000),
    "nemotron-4-340b": (96, 18432, 96, 8, 192, 73728, 256000),
}
MAX_CTX = 512
ATOL = 1e-4
#: smoke block sizes per (layer, kv head): the MHA archs keep 4 kv heads
#: in their smoke variant, the others 2
BLOCK_SIZES = {2: ((16, 32), (64, 16)), 4: ((16, 32, 64, 16), (64, 16, 32, 32))}
VARIANTS = [(True, False), (False, False), (True, True)]
VARIANT_IDS = ["default-fused", "default-staged", "sparse-prefill"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU ops on one thread (the suite runs in parallel
    workers; torch's default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_lists_jax_dense_decoders():
    """JAX's dense decoders, in its registry's order, which the port's
    registry now holds whole (dense, MoE, the vision and audio front-ends'
    backbones and the recurrent families)."""
    want = j_list_archs()
    assert t_list_archs() == want
    dense = {a for a in want if j_get_config(a).family == "dense"}
    assert set(ARCHS) | {"llama3.2-3b", "qwen3-8b"} == dense
    assert set(want) - dense == {"granite-moe-3b-a800m", "grok-1-314b", "internvl2-2b",
                                 "musicgen-large", "recurrentgemma-9b", "rwkv6-3b"}
    assert {a: t_get_config(a).family for a in ("recurrentgemma-9b", "rwkv6-3b")} == {
        "recurrentgemma-9b": "hybrid", "rwkv6-3b": "ssm"}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree_with_jax(arch):
    full_j, full_t = j_get_config(arch), t_get_config(arch)
    for f in FIELDS:
        assert getattr(full_j, f) == getattr(full_t, f), f
    assert (full_t.n_layers, full_t.d_model, full_t.n_heads, full_t.n_kv_heads,
            full_t.resolved_head_dim, full_t.d_ff, full_t.vocab_size) == FULL[arch]
    smoke_j, smoke_t = j_smoke(full_j), t_smoke(full_t)
    for f in FIELDS:
        assert getattr(smoke_j, f) == getattr(smoke_t, f), f
    assert smoke_t.sparse.token_budget == smoke_j.sparse.token_budget == 64


def _cfgs(arch, dtype="float32", fused_decode=True, sparse_prefill=False, **model_kw):
    jb = dataclasses.replace(j_smoke(j_get_config(arch)), **model_kw)
    tb = dataclasses.replace(t_smoke(t_get_config(arch)), **model_kw)
    kw = dict(token_budget=128, block_sizes=BLOCK_SIZES[tb.n_kv_heads],
              prefill_block_q=64, sparse_prefill=sparse_prefill)
    jcfg = dataclasses.replace(jb, dtype=dtype, sparse=dataclasses.replace(
        jb.sparse, backend="reference", **kw))
    tcfg = dataclasses.replace(tb, dtype=dtype, sparse=dataclasses.replace(
        tb.sparse, backend="cuda", fused_decode=fused_decode, **kw))
    return jcfg, tcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bit_exact(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, JTransformer(jcfg).init(jax.random.PRNGKey(2)))
    tm = params_from_jax(tree, tcfg, device="cpu")
    cyc = tree["cycles"]["pos0"]
    names = set()
    for l, layer in enumerate(tm.layers):
        for name, p in layer.named_parameters():
            assert p.dtype == torch.bfloat16
            node = cyc
            for key in _LAYER_KEYS[name]:
                node = node[key]
            np.testing.assert_array_equal(to_numpy(p), np.asarray(node)[l].view(np.uint16))
            names.add(name)
    assert ({"bq", "bk", "bv"} <= names) == tcfg.qkv_bias
    gated = tcfg.activation in tlayers.GATED
    assert ("gate" in names) == gated == ("gate" in cyc["ffn"])
    assert (tm.layers[0].gate is None) == (not gated)
    np.testing.assert_array_equal(to_numpy(tm.embed), tree["embed"].view(np.uint16))
    assert (tm.lm_head is None) == tcfg.tie_embeddings


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_matches_jax(activation):
    rng = np.random.default_rng(len(activation))
    d, f = 32, 96
    w = {n: rng.standard_normal(s).astype(np.float32) * 0.3
         for n, s in (("up", (d, f)), ("gate", (d, f)), ("down", (f, d)))}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    gated = activation in jlayers.GATED
    jp = {n: {"w": jnp.asarray(a)} for n, a in w.items() if gated or n != "gate"}
    want = np.asarray(jlayers.mlp(jp, jnp.asarray(x), activation))
    tp = SimpleNamespace(**{n: torch.from_numpy(a) for n, a in w.items()})
    if not gated:
        tp.gate = None
    got = tlayers.mlp(tp, torch.from_numpy(x), activation).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert tlayers.GATED == jlayers.GATED


def _prefill_and_decode(jcfg, tcfg, seed=0, n_tokens=320, steps=3):
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    tokens = np.random.default_rng(4).integers(0, 256, (1, n_tokens)).astype(np.int32)
    jl, jc = jm.prefill(params, jnp.asarray(tokens), max_context=MAX_CTX)
    tl, tc = tm.prefill(torch.from_numpy(tokens), max_context=MAX_CTX)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
    tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    for _ in range(steps):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok.astype(np.int64)))
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        assert np.array_equal(tok, tl.argmax(-1).numpy())


@pytest.mark.parametrize("fused,sparse_prefill", VARIANTS, ids=VARIANT_IDS)
def test_gemma_at_head_dim_256_matches_jax(fused, sparse_prefill):
    """gemma-7b's smoke variant with its head_dim of 256 restored (4 heads
    of 256 over d_model 64: ``wq`` 64 -> 1024, ``wo`` 1024 -> 64), so the
    CPU holds the model at the head_dim the kernels take on the card."""
    jcfg, tcfg = _cfgs("gemma-7b", fused_decode=fused, sparse_prefill=sparse_prefill,
                       head_dim=256)
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim == 256
    _prefill_and_decode(jcfg, tcfg, seed=1)
