"""Serving musicgen-large's smoke variant (float32, 4 / 4 heads of 16,
sinusoidal positions on) in the port, against JAX on the CPU, at
temperature 0:

- the port's engine with single-shot prefill (``prefill_chunk`` 0) is
  token identical to JAX's engine with ``prefill_chunk`` 0, its
  single-shot path, which adds the positions (JAX's chunked path adds
  none: ``ROADMAP.md`` §3), dense and sparse prefill;
- the port's chunked engine (chunks of 128, the prefix cache installing
  the shared tokens, and a pool of 22 pages that preempts) is token
  identical to its single-shot engine: its chunks add their positions at
  their offsets;
- a request after audio frames follows JAX's model at ``P + S``:
  ``prefill`` with the frames, then ``decode_step``; and a mix of frame
  and plain requests is token identical to JAX's single-shot engine
  (wrapped in ``_jax_slot_reset``).

About 25 s in one process, 66 s under the tier-1 command (one of six
``--dist loadfile`` workers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_dense_engine as dense_engine
from _jax_slot_reset import clear_slots_on_install, count_prefix_rows
from repro.config import ServeConfig as JServe
from repro.models import Transformer as JTransformer
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch.config import ServeConfig as TServe
from repro_torch.convert import params_from_jax
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest

from test_torch_dense_engine import SERVE, check_streams, prompts, serve_both
from test_torch_dense_family import BLOCK_SIZES, _one_thread  # noqa: F401
from test_torch_musicgen import _cfgs

ARCH = "musicgen-large"
NEW_TOKENS = 8


@pytest.mark.parametrize("sparse_prefill", [False, True], ids=["dense", "sparse"])
def test_single_shot_engine_matches_jax(sparse_prefill, monkeypatch):
    monkeypatch.setitem(dense_engine.SPARSE, "block_sizes", BLOCK_SIZES[4])
    monkeypatch.setitem(dense_engine.SPARSE, "sparse_prefill", sparse_prefill)
    jeng, teng, jout, tout = serve_both(ARCH, "cuda", True, "reference",
                                        {"prefill_chunk": 0}, NEW_TOKENS)
    check_streams(jeng, teng, jout, tout, NEW_TOKENS)
    assert teng.model.cfg.name.startswith("musicgen") and teng.prefix_cache is None
    assert len({t for o in tout.values() for t in o}) > 4


def _serve(model, cfg, serve_kw, new_tokens):
    eng = TEngine(cfg, model, TServe(**dict(SERVE, **serve_kw)), seed=0, device="cpu")
    for i, p in enumerate(prompts(cfg.vocab_size)):
        eng.submit(TRequest(req_id=i, prompt=p.astype(np.int32),
                            max_new_tokens=new_tokens))
    return eng, {r.req_id: list(r.output) for r in eng.run_until_done()}


@pytest.mark.parametrize("case", ["dense", "sparse", "preempting"])
def test_chunked_engine_matches_single_shot(case):
    jcfg, tcfg = _cfgs(sparse_prefill=case == "sparse")
    params = JTransformer(jcfg).init(jax.random.PRNGKey(3))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    new = 32 if case == "preempting" else NEW_TOKENS
    extra = {"pool_pages": 22} if case == "preempting" else {}
    _, single = _serve(model, tcfg, {"prefill_chunk": 0}, new)
    eng, chunked = _serve(model, tcfg, extra, new)
    assert chunked == single
    assert all(len(o) == new for o in chunked.values())
    snap = eng.metrics.snapshot()
    # the shared 150 tokens' whole pages, or its whole query blocks under
    # sparse prefill (a resumed sequence hits its own prompt's pages too)
    assert snap["prefix_hit_tokens"] >= (128 if case == "sparse" else 144)
    assert (snap["preemptions"] > 0) == (case == "preempting")
    assert eng.pool.assert_consistent(known_pins=eng.prefix_cache.pages()) == []


def _frames(seed):
    return np.random.default_rng(seed).standard_normal((8, 64)).astype(np.float32)


def test_frames_stream_follows_jax_model():
    """A request after 8 frame embeddings: the port's engine (chunked for
    plain requests, single-shot for this one) gives the greedy
    continuation of JAX's model, whose decode continues at ``P + S``."""
    jcfg, tcfg = _cfgs()
    jm = JTransformer(jcfg)
    params = jm.init(jax.random.PRNGKey(6))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    prompt = np.random.default_rng(5).integers(0, 256, 120).astype(np.int32)
    frames = _frames(6)
    jl, jc = jm.prefill(params, jnp.asarray(prompt)[None], jnp.asarray(frames)[None],
                        max_context=SERVE["max_context"])
    assert int(jc["seq_len"][0]) == 128
    want = [int(jnp.argmax(jl[0]))]
    for _ in range(NEW_TOKENS - 1):
        jl, jc = jm.decode_step(params, jc, jnp.asarray([want[-1]], jnp.int32))
        want.append(int(jnp.argmax(jl[0])))
    assert len(set(want)) > 1
    teng = TEngine(tcfg, model, TServe(**SERVE), seed=0, device="cpu")
    teng.submit(TRequest(req_id=0, prompt=prompt, max_new_tokens=NEW_TOKENS,
                         prefix_emb=frames))
    assert list(teng.run_until_done()[0].output) == want


def test_frames_and_plain_requests_match_jax_single_shot_engine():
    jcfg, tcfg = _cfgs()
    params = JTransformer(jcfg).init(jax.random.PRNGKey(7))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    serve = dict(SERVE, prefill_chunk=0)
    jeng = count_prefix_rows(clear_slots_on_install(
        JEngine(jcfg, params, JServe(**serve), seed=0)))
    teng = TEngine(tcfg, model, TServe(**serve), seed=0, device="cpu")
    reqs = [(p, _frames(20 + i) if i % 2 else None)
            for i, p in enumerate(prompts(tcfg.vocab_size))]
    for eng, Req in ((jeng, JRequest), (teng, TRequest)):
        for i, (p, pre) in enumerate(reqs):
            eng.submit(Req(req_id=i, prompt=p.astype(np.int32),
                           max_new_tokens=NEW_TOKENS, prefix_emb=pre))
    jout = {r.req_id: list(r.output) for r in jeng.run_until_done()}
    tout = {r.req_id: list(r.output) for r in teng.run_until_done()}
    assert tout == jout
    assert all(len(o) == NEW_TOKENS for o in tout.values())
    # random weights under large positions repeat tokens; the requests'
    # streams still differ
    assert len({tuple(o) for o in tout.values()}) == 4
