"""Prefix-embedding requests (internvl2-2b's stubbed vision front-end) in
the port, against JAX on the CPU, on internvl2-2b's smoke variant
(float32, 8 prefix embeddings of width 64):

- the config agrees with JAX's field by field, full and smoke;
- ``Transformer.embed_inputs`` equals JAX's (embeddings before the
  tokens), and ``prefill`` with prefix embeddings gives logits within
  1e-4 of JAX's and a cache of ``P + S`` rows, then three decode steps
  with greedy tokens identical to JAX's model, for the default
  configuration and the ``"dense"`` backend;
- engine streams for a mix of prefix and plain requests are token
  identical to JAX's engine at temperature 0 (both wrapped in
  ``_jax_slot_reset``: slots cleared on install, and the slot's length
  after a prefix prefill counting the embeddings' rows, which JAX's engine
  leaves out: ``ROADMAP.md`` §3); a prefix request prefills in one shot,
  never in chunks, and never enters the prefix cache, while the plain
  ones chunk and hit it;
- a prefix request's stream equals the greedy continuation of JAX's own
  model (``prefill`` with the embeddings, then ``decode_step``), which the
  engine's slot length must follow;
- ``submit`` counts the embeddings' rows against ``max_context``;
- a dense model (llama3.2-3b's smoke variant) embeds a prefix request's
  tokens alone, as JAX's ``embed_inputs`` does: its slot holds the
  prompt's rows only, ``submit`` counts no prefix rows, and its stream is
  token identical to JAX's engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_slot_reset import clear_slots_on_install, count_prefix_rows
from repro.config import ServeConfig as JServe
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.models import Transformer as JTransformer
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch.config import ServeConfig as TServe
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest

from test_torch_dense_family import BLOCK_SIZES, _one_thread  # noqa: F401
from test_torch_qwen3 import FIELDS

ARCH = "internvl2-2b"
MAX_CTX = 512
ATOL = 1e-4
SERVE = dict(max_batch=2, max_context=MAX_CTX, prefill_chunk=128,
             prefill_tokens_per_tick=192, temperature=0.0)
NEW_TOKENS = 8


def test_config_agrees_with_jax():
    full_j, full_t = j_get_config(ARCH), t_get_config(ARCH)
    for cj, ct in ((full_j, full_t), (j_smoke(full_j), t_smoke(full_t))):
        for f in FIELDS + ("family", "frontend", "n_prefix_embeddings", "moe"):
            assert getattr(cj, f) == getattr(ct, f), f
    assert (full_t.n_layers, full_t.d_model, full_t.n_heads, full_t.n_kv_heads,
            full_t.resolved_head_dim, full_t.d_ff, full_t.vocab_size,
            full_t.n_prefix_embeddings) == (24, 2048, 16, 8, 128, 8192, 92553, 256)
    assert full_t.family == "vlm" and full_t.frontend == "vision_patches"
    assert t_smoke(full_t).n_prefix_embeddings == 8


def _cfgs(t_backend="cuda", fused=True, j_backend="reference", arch=ARCH):
    jb, tb = j_smoke(j_get_config(arch)), t_smoke(t_get_config(arch))
    kw = dict(token_budget=128, block_sizes=BLOCK_SIZES[tb.n_kv_heads],
              prefill_block_q=64)
    jcfg = dataclasses.replace(jb, sparse=dataclasses.replace(
        jb.sparse, backend=j_backend, **kw))
    tcfg = dataclasses.replace(tb, sparse=dataclasses.replace(
        tb.sparse, backend=t_backend, fused_decode=fused, **kw))
    return jcfg, tcfg


def _models(seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jm, params, tm


def _prefix(seed, d=64, batch=None):
    """Seeded patch embeddings ``[P, d]`` (``[batch, P, d]``), scaled like
    hidden states so they move the logits."""
    shape = (8, d) if batch is None else (batch, 8, d)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, n)).astype(np.int32)


def test_embed_inputs_match_jax():
    jm, params, tm = _models()
    tokens, pre = _tokens(20), _prefix(1, batch=1)
    want = np.asarray(jm.embed_inputs(params, jnp.asarray(tokens), jnp.asarray(pre)))
    got = tm.embed_inputs(torch.from_numpy(tokens).long(), torch.from_numpy(pre))
    assert got.shape == (1, 28, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tm.embed_inputs(torch.from_numpy(tokens).long())
    np.testing.assert_array_equal(plain.numpy(), got[:, 8:].numpy())


@pytest.mark.parametrize("backend", ["default", "dense"])
def test_prefill_with_prefix_matches_jax(backend):
    kw = {} if backend == "default" else dict(t_backend="dense", fused=False,
                                              j_backend="dense")
    jm, params, tm = _models(seed=1, **kw)
    tokens, pre = _tokens(200, seed=2), _prefix(3, batch=1)
    jl, jc = jm.prefill(params, jnp.asarray(tokens), jnp.asarray(pre),
                        max_context=MAX_CTX)
    tl, tc = tm.prefill(torch.from_numpy(tokens), torch.from_numpy(pre),
                        max_context=MAX_CTX)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
    assert int(tc["seq_len"][0]) == int(jc["seq_len"][0]) == 208
    tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok.astype(np.int64)))
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        assert np.array_equal(tok, tl.argmax(-1).numpy())


def _requests(vocab=256):
    """Two prompts sharing a 150-token prefix (plain), two with prefix
    embeddings (one shares the same 150 tokens)."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, 150)
    return [
        (np.concatenate([shared, rng.integers(0, vocab, 60)]), None),
        (np.concatenate([shared, rng.integers(0, vocab, 90)]), _prefix(20)),
        (np.concatenate([shared, rng.integers(0, vocab, 40)]), None),
        (rng.integers(0, vocab, 75), _prefix(21)),
    ]


def test_engine_mixes_prefix_and_plain_requests_as_jax():
    jcfg, tcfg = _cfgs()
    params = JTransformer(jcfg).init(jax.random.PRNGKey(3))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    jeng = count_prefix_rows(clear_slots_on_install(
        JEngine(jcfg, params, JServe(**SERVE), seed=0)))
    teng = TEngine(tcfg, model, TServe(**SERVE), seed=0, device="cpu")
    monolithic = []
    orig = teng._prefill_monolithic
    teng._prefill_monolithic = lambda seq: (monolithic.append(seq.req.req_id), orig(seq))
    for eng, Req in ((jeng, JRequest), (teng, TRequest)):
        for i, (p, pre) in enumerate(_requests()):
            eng.submit(Req(req_id=i, prompt=p.astype(np.int32),
                           max_new_tokens=NEW_TOKENS, prefix_emb=pre))
    jout = {r.req_id: list(r.output) for r in jeng.run_until_done()}
    tout = {r.req_id: list(r.output) for r in teng.run_until_done()}
    assert tout == jout
    assert all(len(o) == NEW_TOKENS for o in tout.values())
    assert len({t for o in tout.values() for t in o}) > 4
    assert sorted(monolithic) == [1, 3]
    snap, jsnap = teng.metrics.snapshot(), jeng.metrics.snapshot()
    # request 2 hits request 0's 144 shared tokens; request 1 shares them
    # too, but prefills in one shot and publishes nothing
    assert snap["prefix_hit_tokens"] == jsnap["prefix_hit_tokens"] == 144
    assert teng.prefix_cache is not None
    assert teng.pool.assert_consistent(known_pins=teng.prefix_cache.pages()) == []


def test_prefix_stream_follows_jax_model():
    """A prefix request's greedy stream is the JAX model's: ``prefill``
    with its embeddings (a cache of P + S rows), then ``decode_step``."""
    jcfg, tcfg = _cfgs()
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.PRNGKey(4))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    prompt, pre = _tokens(120, seed=5)[0], _prefix(6)
    jl, jc = jm.prefill(params, jnp.asarray(prompt)[None], jnp.asarray(pre)[None],
                        max_context=MAX_CTX)
    want = [int(jnp.argmax(jl[0]))]
    for _ in range(NEW_TOKENS - 1):
        jl, jc = jm.decode_step(params, jc, jnp.asarray([want[-1]], jnp.int32))
        want.append(int(jnp.argmax(jl[0])))
    assert len(set(want)) > 1
    teng = TEngine(tcfg, model, TServe(**SERVE), seed=0, device="cpu")
    teng.submit(TRequest(req_id=0, prompt=prompt, max_new_tokens=NEW_TOKENS,
                         prefix_emb=pre))
    assert list(teng.run_until_done()[0].output) == want
    with pytest.raises(ValueError, match="prefix rows"):
        teng.submit(TRequest(req_id=1, prompt=np.zeros(MAX_CTX - 12, np.int32),
                             max_new_tokens=8, prefix_emb=pre))


def test_dense_model_serves_prefix_request_without_its_rows():
    """A dense model's engine serves a prefix request on its tokens alone:
    the stream equals JAX's engine's (whose slot length, the prompt's, is
    right here) and the request's stream without the embeddings, and
    ``submit`` takes a prompt that fills ``max_context`` with them."""
    jcfg, tcfg = _cfgs(arch="llama3.2-3b")
    params = JTransformer(jcfg).init(jax.random.PRNGKey(5))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    serve = dict(SERVE, prefill_chunk=0)
    jeng = count_prefix_rows(clear_slots_on_install(
        JEngine(jcfg, params, JServe(**serve), seed=0)))
    teng = TEngine(tcfg, model, TServe(**serve), seed=0, device="cpu")
    prompt, pre = _tokens(120, seed=7)[0], _prefix(8)
    for eng, Req in ((jeng, JRequest), (teng, TRequest)):
        eng.submit(Req(req_id=0, prompt=prompt, max_new_tokens=NEW_TOKENS,
                       prefix_emb=pre))
        eng.submit(Req(req_id=1, prompt=prompt, max_new_tokens=NEW_TOKENS))
    jout = {r.req_id: list(r.output) for r in jeng.run_until_done()}
    tout = {r.req_id: list(r.output) for r in teng.run_until_done()}
    assert tout == jout
    assert tout[0] == tout[1] and len(set(tout[0])) > 1
    teng.submit(TRequest(req_id=2, prompt=np.zeros(MAX_CTX - NEW_TOKENS, np.int32),
                         max_new_tokens=NEW_TOKENS, prefix_emb=pre))
