"""The recurrent families in the port against JAX on the CPU:
recurrentgemma-9b (RG-LRU and local attention, cycles of (rglru, rglru,
local_attn)) and rwkv6-3b (RWKV-6 time mixing), on their smoke variants
(float32; recurrentgemma's at 5 layers, so that one cycle and two
remainder layers run, ``rest_kinds`` (rglru, rglru)):

- the configs and ``smoke_variant`` equal JAX's field by field, and the
  full configs' layer kinds are JAX's plan (recurrentgemma: 12 cycles,
  then rglru, rglru);
- ``params_from_jax`` carries the bf16 weights of JAX's ``cycles.pos{i}``
  and ``rest[j]`` trees bit-exactly, layer by layer;
- ``prefill`` logits (1e-4) and every layer's cache entry (ring buffers,
  recurrent states; 1e-4) against JAX's, then 12 ``decode_step`` calls
  (logits 1e-4, greedy tokens identical, the entries again);
- decode continues prefill (JAX's invariant, ``tests/test_models.py``):
  in the port, the last-row logits of a prefill of the prompt plus the
  first j decoded tokens equal the decode step's (1e-4);
- the plan is inactive, ``supports_chunked_prefill`` is False and the
  chunked entry points raise; AB-Sparse enabled on such a stack raises;
- ``Transformer.init`` sets JAX's constants (``lam`` = linspace(2, 6),
  ``conv_b`` 0, ``mu`` and ``u`` 0.5, ``w_bias`` -2) and a truncated
  ``conv_w`` of std 0.1.

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

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import jax_layer, layer_keys, params_from_jax, to_numpy
from repro_torch.models import Transformer

from test_torch_dense_family import _one_thread  # noqa: F401

ARCHS = ("recurrentgemma-9b", "rwkv6-3b")
#: smoke depth: recurrentgemma's 5 layers run one cycle and two remainder
#: layers
LAYERS = {"recurrentgemma-9b": 5, "rwkv6-3b": 2}
ATOL = 1e-4


def _cfgs(arch, dtype="float32"):
    kw = dict(n_layers=LAYERS[arch], dtype=dtype)
    return (dataclasses.replace(j_smoke(j_get_config(arch)), **kw),
            dataclasses.replace(t_smoke(t_get_config(arch)), **kw))


def _models(arch, seed=0, dtype="float32"):
    jc, tc = _cfgs(arch, dtype)
    jm = JTransformer(jc)
    params = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return jm, params, tree, params_from_jax(tree, tc, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree_with_jax(arch):
    full_j, full_t = j_get_config(arch), t_get_config(arch)
    for cj, ct in ((full_j, full_t), (j_smoke(full_j), t_smoke(full_t))):
        for f in dataclasses.fields(ct):
            if f.name != "sparse":
                assert getattr(cj, f.name) == getattr(ct, f.name), f.name
        for f in dataclasses.fields(ct.sparse):
            assert getattr(cj.sparse, f.name) == getattr(ct.sparse, f.name), f.name
        assert ct.layer_kinds == cj.layer_kinds
        assert ct.is_attention_free == cj.is_attention_free
        assert not ct.sparse.enabled
    if arch == "recurrentgemma-9b":
        kinds = full_t.layer_kinds
        assert len(kinds) == 38 and kinds[:3] == ("rglru", "rglru", "local_attn")
        assert kinds[36:] == ("rglru", "rglru") and kinds.count("local_attn") == 12
        assert (full_t.n_kv_heads, full_t.resolved_head_dim, full_t.local_window) == (1, 256,
                                                                                   2048)
        assert t_smoke(full_t).local_window == 64 and t_smoke(full_t).n_kv_heads == 1
    else:
        assert full_t.is_attention_free and full_t.rwkv_head_dim == 64


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bit_exact(arch):
    _, _, tree, tm = _models(arch, seed=2, dtype="bfloat16")
    seen = set()
    for l, layer in enumerate(tm.layers):
        node0, c = jax_layer(tree, tm.cfg, l)
        assert (c is None) == (l >= 3 and arch == "recurrentgemma-9b")
        for name, p in layer.named_parameters():
            node = node0
            for key in layer_keys(tm.cfg, layer.kind)[name]:
                node = node[key]
            a = np.asarray(node) if c is None else np.asarray(node)[c]
            if a.dtype.name == "bfloat16":
                np.testing.assert_array_equal(to_numpy(p), a.view(np.uint16))
            else:
                assert p.dtype == torch.float32
                np.testing.assert_array_equal(p.numpy(), a)
            seen.add((layer.kind, name))
    kinds = {k for k, _ in seen}
    assert kinds == set(tm.cfg.layer_pattern)
    if arch == "recurrentgemma-9b":
        assert {("rglru", n) for n in ("lam", "conv_w", "conv_b", "w_a", "out")} <= seen
        assert ("local_attn", "wq") in seen
    else:
        assert {("rwkv", n) for n in ("mu", "u", "w_bias", "ww", "ln_x")} <= seen


def _entries_match(jcache, tm, tcache):
    for l, (layer, e) in enumerate(zip(tm.layers, tcache["layers"])):
        n = len(tm.cfg.layer_pattern)
        nc = tm.cfg.n_layers // n
        je = jcache[f"pos{l % n}"] if l < nc * n else jcache["rest"][l - nc * n]
        for name, t in e.items():
            want = np.asarray(je[name])[l // n] if l < nc * n else np.asarray(je[name])
            np.testing.assert_allclose(t.numpy(), want, atol=ATOL, rtol=1e-4,
                                       err_msg=f"layer {l} ({layer.kind}) {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jm, params, _, tm = _models(arch, seed=3)
    toks = np.random.default_rng(1).integers(0, 256, (2, 150)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="max_context")(
        params, jnp.asarray(toks), max_context=256)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_context=256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _entries_match(jc, tm, tc)
    j_decode = jax.jit(jm.decode_step)
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(12):
        jl, jc = j_decode(params, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok.astype(np.int64)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        assert np.array_equal(tok, tl.argmax(-1).numpy())
    _entries_match(jc, tm, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_prefill(arch):
    _, _, _, tm = _models(arch, seed=4)
    # 100 tokens, then 40 decoded: recurrentgemma's window of 64 wraps
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 100)))
    logits, cache = tm.prefill(toks, max_context=160)
    seq, steps = toks, []
    for _ in range(40):
        nxt = logits.argmax(-1)
        steps.append(logits)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
        logits, cache = tm.decode_step(cache, nxt)
    for j in (1, 17, 40):
        want, _ = tm.prefill(seq[:, :100 + j], max_context=160)
        got = steps[j] if j < 40 else logits
        torch.testing.assert_close(got, want, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_inactive_and_single_shot_only(arch):
    _, tc = _cfgs(arch)
    tm = Transformer(tc, device="cpu")
    assert not tm.use_sparse(4096) and not tm.attention_plan(4096).layouts
    assert not tm.supports_chunked_prefill()
    cache = tm.init_cache(2, 256)
    assert all(la is None for la in cache["la"])
    for call in (lambda: tm.prefill_chunk(cache, 0, np.zeros(64, np.int64), 0, 64),
                 lambda: tm.refresh_slot_store(cache, 0),
                 lambda: tm.refresh_slot_score_rows(cache, 0)):
        with pytest.raises(ValueError, match="one shot"):
            call()
    on = dataclasses.replace(tc, sparse=dataclasses.replace(tc.sparse, enabled=True))
    with pytest.raises(ValueError, match="homogeneous global-attention"):
        Transformer(on, device="cpu")


def test_init_sets_jax_constants():
    _, tc = _cfgs("recurrentgemma-9b")
    _, wc = _cfgs("rwkv6-3b")
    gen = torch.Generator().manual_seed(0)
    rg = Transformer(tc, device="cpu").init(gen)
    rw = Transformer(wc, device="cpu").init(gen)
    rec = rg.layers[0]
    torch.testing.assert_close(rec.lam, torch.linspace(2.0, 6.0, tc.d_model))
    assert rec.lam.dtype == torch.float32 and torch.all(rec.conv_b == 0)
    assert rec.conv_w.abs().max() <= 0.2 and rec.conv_w.std() > 0.05
    assert rg.layers[2].kind == "local_attn" and rg.layers[2].wq.std() > 0.05
    tmix = rw.layers[0]
    assert torch.all(tmix.mu == 0.5) and torch.all(tmix.u == 0.5)
    assert torch.all(tmix.w_bias == -2.0) and torch.all(tmix.ln_x == 1.0)
    assert tmix.ww.std() > 0.05
