"""musicgen-large in the port, against JAX on the CPU, on its smoke variant
(float32, 2 layers, 4 / 4 heads of 16, vocab 256, the name kept, so the
sinusoidal positions stay on):

- the config and ``smoke_variant`` equal JAX's field by field (the
  sparse settings too);
- ``params_from_jax`` carries its bf16 weights bit-exactly, the untied
  ``lm_head`` and the GELU MLP's missing gate included;
- ``layers.sinusoidal_embedding`` against JAX's at positions up to 16384
  (the two frameworks' f32 ``exp`` differ by one ulp in about a tenth of
  the frequencies, and a position ``p`` turns that into ``p`` ulps of the
  angle, so each element is held to that bound; at equal frequencies the
  two agree to 2e-7);
- ``embed_inputs`` with and without audio frames (positions ``0 .. P + S
  - 1``);
- ``prefill`` logits (1e-4) and every layer's K / V (1e-5) against JAX's
  ``prefill``, dense and sparse prefill, with and without frames;
- 8 ``decode_step`` calls from JAX's prefill cache carried into the port,
  logits within 1e-4, greedy tokens identical and the sparse selections
  exact: per step the sparsity counters of every layer and slot and the
  selected and margin-predicted page masks equal JAX's, fused and staged;
- the port's chunked prefill against its single-shot prefill, dense (at
  unaligned offsets) and sparse (at query-block offsets): logits within
  1e-5 and K within ``CHUNK_K_ATOL``; both against JAX's ``prefill``
  (logits within 1e-4);
- the reference's fault, pinned: JAX's ``prefill_chunk`` adds no
  positions, so its chunked logits differ from its own ``prefill``'s, and
  equal (1e-4) those of a JAX model whose name turns the positions off.
  The port diverges on purpose (``ROADMAP.md`` §3); if JAX is repaired,
  this test shows it.

About 30 s in one process, 76 s under the tier-1 command (one of six
``--dist loadfile`` workers).
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
from repro.models import layers as jlayers

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import _LAYER_KEYS, params_from_jax, to_numpy, to_torch
from repro_torch.models import layers as tlayers

from test_torch_dense import CHUNK_K_ATOL
from test_torch_dense_family import BLOCK_SIZES, _one_thread  # noqa: F401

ARCH = "musicgen-large"
MAX_CTX = 512
ATOL = 1e-4
#: (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab)
FULL = (48, 2048, 32, 32, 64, 8192, 2048)
N_FRAMES = 8


def test_config_agrees_with_jax():
    full_j, full_t = j_get_config(ARCH), t_get_config(ARCH)
    for cj, ct in ((full_j, full_t), (j_smoke(full_j), t_smoke(full_t))):
        for f in dataclasses.fields(ct):
            if f.name != "sparse":
                assert getattr(cj, f.name) == getattr(ct, f.name), f.name
        for f in dataclasses.fields(ct.sparse):
            assert getattr(cj.sparse, f.name) == getattr(ct.sparse, f.name), f.name
        assert ct.name.startswith("musicgen")
    assert (full_t.n_layers, full_t.d_model, full_t.n_heads, full_t.n_kv_heads,
            full_t.resolved_head_dim, full_t.d_ff, full_t.vocab_size) == FULL
    assert (full_t.family, full_t.frontend, full_t.activation) == (
        "audio", "audio_frames", "gelu")
    assert not full_t.tie_embeddings and full_t.layer_pattern == ("attn",)
    assert t_smoke(full_t).name == "musicgen-large-smoke"


def test_params_round_trip_bit_exact():
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs())
    tree = jax.tree.map(np.asarray, JTransformer(jcfg).init(jax.random.PRNGKey(2)))
    tm = params_from_jax(tree, tcfg, device="cpu")
    assert tm.lm_head is not None and tm.lm_head.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(tm.lm_head), tree["lm_head"].view(np.uint16))
    np.testing.assert_array_equal(to_numpy(tm.embed), tree["embed"].view(np.uint16))
    np.testing.assert_array_equal(to_numpy(tm.final_norm),
                                  tree["final_norm"]["scale"].view(np.uint16))
    cyc, names = tree["cycles"]["pos0"], set()
    for l, layer in enumerate(tm.layers):
        for name, p in layer.named_parameters():
            node = cyc
            for key in _LAYER_KEYS[name]:
                node = node[key]
            np.testing.assert_array_equal(to_numpy(p), np.asarray(node)[l].view(np.uint16))
            names.add(name)
    assert names == {"norm1", "norm2", "wq", "wk", "wv", "wo", "up", "down"}
    assert "gate" not in cyc["ffn"] and tm.layers[0].gate is None


@pytest.mark.parametrize("d", [64, 2048])
def test_sinusoidal_embedding_matches_jax(d):
    pos = np.concatenate([np.arange(0, 16385, 7), [16383, 16384]]).astype(np.int32)
    want = np.asarray(jlayers.sinusoidal_embedding(jnp.asarray(pos), d))
    got = tlayers.sinusoidal_embedding(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == (len(pos), d)
    got = got.numpy()
    half = d // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half).astype(np.float32)
    angle = pos[:, None].astype(np.float32) * freqs
    # a one-ulp frequency times the position, the angle's own rounding,
    # and the sine's error at one angle
    bound = pos[:, None] * np.spacing(freqs) + np.spacing(angle) + 2e-7
    bound = np.concatenate([bound, bound], axis=1)
    assert np.all(np.abs(got - want) <= bound)
    # ... and at one angle (JAX's frequencies) the two agree to 2e-7
    jf = np.asarray(jnp.exp(-np.log(10000.0) * jnp.arange(half, dtype=jnp.float32) / half))
    ang = torch.from_numpy(pos[:, None].astype(np.float32) * jf)
    same = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).numpy()
    np.testing.assert_allclose(same, want, atol=2e-7, rtol=0)


def _cfgs(fused=True, sparse_prefill=False, name=None):
    jb, tb = j_smoke(j_get_config(ARCH)), t_smoke(t_get_config(ARCH))
    if name is not None:
        jb, tb = (dataclasses.replace(c, name=name) for c in (jb, tb))
    kw = dict(token_budget=128, block_sizes=BLOCK_SIZES[tb.n_kv_heads],
              prefill_block_q=64, sparse_prefill=sparse_prefill)
    jcfg = dataclasses.replace(jb, sparse=dataclasses.replace(
        jb.sparse, backend="reference", **kw))
    tcfg = dataclasses.replace(tb, sparse=dataclasses.replace(
        tb.sparse, backend="cuda", fused_decode=fused, **kw))
    return jcfg, tcfg


def _models(seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jm, params, tm


def _tokens(n, seed=0, batch=1):
    return np.random.default_rng(seed).integers(0, 256, (batch, n)).astype(np.int32)


def _frames(seed, batch=1):
    """Seeded audio-frame embeddings ``[batch, N_FRAMES, 64]``."""
    return np.random.default_rng(seed).standard_normal(
        (batch, N_FRAMES, 64)).astype(np.float32)


def test_embed_inputs_match_jax():
    jm, params, tm = _models()
    tokens, frames = _tokens(20), _frames(1)
    for pre in (None, frames):
        want = np.asarray(jm.embed_inputs(
            params, jnp.asarray(tokens), None if pre is None else jnp.asarray(pre)))
        got = tm.embed_inputs(torch.from_numpy(tokens).long(),
                              None if pre is None else torch.from_numpy(pre))
        assert got.shape == (1, 20 + (0 if pre is None else N_FRAMES), 64)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the frames take positions 0 .. P - 1, the tokens P .. P + S - 1
    pos = tlayers.sinusoidal_embedding(torch.arange(20 + N_FRAMES), 64)
    np.testing.assert_allclose(got[0, N_FRAMES:].numpy(),
                               (tm.embed[torch.from_numpy(tokens[0]).long()]
                                + pos[N_FRAMES:]).numpy(), atol=1e-7, rtol=0)
    # a model of another name adds no positions
    _, plain = _cfgs(name="audio-smoke")
    tm.cfg = plain
    np.testing.assert_array_equal(tm.embed_inputs(torch.from_numpy(tokens).long()).numpy(),
                                  tm.embed[torch.from_numpy(tokens).long()].numpy())


@pytest.mark.parametrize("frames", [False, True], ids=["tokens", "frames"])
@pytest.mark.parametrize("sparse_prefill", [False, True], ids=["dense", "sparse"])
def test_prefill_matches_jax(sparse_prefill, frames):
    jm, params, tm = _models(seed=1, sparse_prefill=sparse_prefill)
    tokens = _tokens(300, seed=2)
    pre = _frames(3) if frames else None
    jl, jc = jm.prefill(params, jnp.asarray(tokens),
                        None if pre is None else jnp.asarray(pre), max_context=MAX_CTX)
    tl, tc = tm.prefill(torch.from_numpy(tokens), None if pre is None else
                        torch.from_numpy(pre), max_context=MAX_CTX)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
    n = 300 + (N_FRAMES if frames else 0)
    assert int(tc["seq_len"][0]) == int(jc["seq_len"][0]) == n
    for l, e in enumerate(tc["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(e[name].numpy(),
                                       np.asarray(jc["pos0"][name][l]), atol=1e-5)


def _carry(jcache, tm):
    """JAX's cache as the port's: every per-layer entry and the lengths."""
    cache = tm.init_cache(jcache["seq_len"].shape[0], MAX_CTX)
    for l, e in enumerate(cache["layers"]):
        for name, t in e.items():
            t.copy_(to_torch(np.asarray(jcache["pos0"][name][l])))
    cache["seq_len"].copy_(to_torch(np.asarray(jcache["seq_len"])))
    return cache


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_decode_steps_from_jax_cache_match_jax(fused):
    """Two slots of 300 tokens prefilled by JAX, the cache carried into the
    port; then 8 steps, each with the sparsity counters and the selected /
    predicted page masks planted in both."""
    jm, params, tm = _models(seed=4, fused=fused)
    jl, jc = jm.prefill(params, jnp.asarray(_tokens(300, seed=5, batch=2)),
                        max_context=MAX_CTX)
    tc = _carry(jc, tm)
    jc, tc = dict(jc), tc
    L, n_pages = tm.cfg.n_layers, MAX_CTX // 16
    jc["_telemetry"] = jnp.zeros((L, 2, 4), jnp.int32)
    tc["_telemetry"] = torch.zeros((L, 2, 4), dtype=torch.int32)
    for key in ("_sel_pages", "_pre_pages"):
        jc[key] = jnp.zeros((2, n_pages), bool)
        tc[key] = torch.zeros((2, n_pages), dtype=torch.bool)
    tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    for _ in range(8):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok.astype(np.int64)))
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
        for key in ("_telemetry", "_sel_pages", "_pre_pages"):
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]), key)
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        assert np.array_equal(tok, tl.argmax(-1).numpy())
    assert int(tc["_telemetry"][..., 0].sum()) > 0
    assert tc["seq_len"].tolist() == [308, 308]


#: (offset, tokens) of a dense run's chunk buffers of 64, off the query
#: block, and of a sparse run's, on it
DENSE_CHUNKS = ((0, 50), (50, 64), (114, 13), (127, 64), (191, 9))
SPARSE_CHUNKS = ((0, 64), (64, 64), (128, 64), (192, 8))


def _port_chunked(tm, tokens, chunks):
    cache = tm.init_cache(1, MAX_CTX)
    last = None
    for off, n in chunks:
        buf = np.zeros((64,), np.int64)
        buf[:n] = tokens[0, off:off + n]
        last, cache = tm.prefill_chunk(cache, 0, buf, off, n)
    return last, cache


@pytest.mark.parametrize("sparse_prefill", [False, True], ids=["dense", "sparse"])
def test_chunked_prefill_equals_single_shot_and_jax(sparse_prefill):
    """The port's chunk adds its positions at its offset, so chunked equals
    single-shot prefill, and both JAX's ``prefill``."""
    chunks = SPARSE_CHUNKS if sparse_prefill else DENSE_CHUNKS
    jm, params, tm = _models(seed=6, sparse_prefill=sparse_prefill)
    n = sum(chunks[-1])
    tokens = _tokens(n, seed=7)
    single, cs = tm.prefill(torch.from_numpy(tokens), max_context=MAX_CTX)
    last, cc = _port_chunked(tm, tokens, chunks)
    np.testing.assert_allclose(last.numpy(), single[0].numpy(), atol=1e-5)
    for a, b in zip(cc["layers"], cs["layers"]):
        np.testing.assert_allclose(a["k"].numpy(), b["k"].numpy(), atol=CHUNK_K_ATOL)
    jl, _ = jm.prefill(params, jnp.asarray(tokens), max_context=MAX_CTX)
    np.testing.assert_allclose(np.asarray(jl[0]), last.numpy(), atol=ATOL)


def test_reference_chunked_prefill_has_no_positions():
    """The reference's fault, pinned: JAX's ``prefill_chunk`` embeds the
    tokens alone, so its last logits are those of the same weights under a
    name without positions, not its own ``prefill``'s."""
    jm, params, _ = _models(seed=8)
    nopos = JTransformer(_cfgs(name="audio-smoke")[0])
    tokens = _tokens(200, seed=9)
    cache = jm.init_cache(1, MAX_CTX)
    for off, n in ((0, 64), (64, 64), (128, 64), (192, 8)):
        buf = np.zeros((64,), np.int32)
        buf[:n] = tokens[0, off:off + n]
        chunked, cache = jm.prefill_chunk(params, cache, jnp.int32(0), jnp.asarray(buf),
                                          jnp.int32(off), jnp.int32(n))
    single, _ = jm.prefill(params, jnp.asarray(tokens), max_context=MAX_CTX)
    without, _ = nopos.prefill(params, jnp.asarray(tokens), max_context=MAX_CTX)
    assert np.abs(np.asarray(chunked) - np.asarray(single[0])).max() > 100 * ATOL
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(without[0]), atol=ATOL)
