"""Serving-level parity of the port's dense paths with the JAX engine, on
the CPU.

Both engines serve the smoke variant of llama3.2-3b (float32, fixed
non-uniform block sizes) at temperature 0, the port through its kernel
wrappers (their plain versions on CPU tensors):

- the repo's default configuration (``sparse_prefill`` off: dense chunked
  prefill, sparse decode, fused and staged), with two prompts sharing a
  150-token prefix, so the prefix cache installs 144 tokens and the next
  chunk starts at an offset that is no multiple of the query block; once
  more with a page pool too small for every sequence's decode growth, so
  sequences are preempted and replay their tokens;
- an inactive plan (``max_context`` 250, under twice the budget and no
  multiple of the page size: dense prefill, dense decode, no store);
- single-shot prefill (``prefill_chunk`` 0: no chunks, no prefix cache);
- the ``"dense"`` backend (the Full Attention baseline).

Token streams must be identical, the prefix-hit and preemption counts
equal to JAX's, and the port's page pool must audit clean at drain.
"""
import dataclasses

import jax
import numpy as np
import pytest

from _jax_slot_reset import clear_slots_on_install
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

SPARSE = dict(token_budget=128, block_sizes=((16, 32), (64, 16)),
              sparse_prefill=False, prefill_block_q=64)
SERVE = dict(max_batch=2, max_context=512, prefill_chunk=128,
             prefill_tokens_per_tick=192, temperature=0.0)
#: case -> (port backend, fused decode, JAX backend, serve overrides,
#: new tokens)
CASES = {
    "default-fused": ("cuda", True, "reference", {}, 5),
    "default-staged": ("cuda", False, "reference", {}, 5),
    "default-preempting": ("cuda", True, "reference", {"pool_pages": 22}, 32),
    "inactive": ("cuda", False, "reference", {"max_context": 250}, 5),
    "monolithic": ("cuda", True, "reference", {"prefill_chunk": 0}, 5),
    "dense": ("dense", False, "dense", {}, 5),
}


def prompts(vocab=256):
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, 150)
    return [
        np.concatenate([shared, rng.integers(0, vocab, 60)]),
        np.concatenate([shared, rng.integers(0, vocab, 90)]),
        rng.integers(0, vocab, 170),
        rng.integers(0, vocab, 75),
    ]


def serve_both(arch, t_backend, fused, j_backend, serve_kw, new_tokens, seed=3,
               attach=None, adjust=None):
    """Serve ``prompts()`` through the JAX and the port engine -> (JAX
    engine, port engine, JAX outputs, port outputs) by request id;
    ``attach(port engine)`` runs before the engines do, ``adjust(config)``
    (given each package's smoke config) changes both models alike."""
    jb, tb = j_smoke(j_get_config(arch)), t_smoke(t_get_config(arch))
    if adjust is not None:
        jb, tb = adjust(jb), adjust(tb)
    jcfg = dataclasses.replace(
        jb, sparse=dataclasses.replace(jb.sparse, backend=j_backend, **SPARSE))
    tcfg = dataclasses.replace(
        tb, sparse=dataclasses.replace(tb.sparse, backend=t_backend,
                                       fused_decode=fused, **SPARSE))
    params = JTransformer(jcfg).init(jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    serve = dict(SERVE, **serve_kw)
    jeng = clear_slots_on_install(JEngine(jcfg, params, JServe(**serve), seed=0))
    teng = TEngine(tcfg, model, TServe(**serve), seed=0, device="cpu")
    for eng, Req in ((jeng, JRequest), (teng, TRequest)):
        for i, p in enumerate(prompts(tcfg.vocab_size)):
            eng.submit(Req(req_id=i, prompt=p.astype(np.int32),
                           max_new_tokens=new_tokens))
    if attach is not None:
        attach(teng)
    jout = {r.req_id: list(r.output) for r in jeng.run_until_done()}
    tout = {r.req_id: list(r.output) for r in teng.run_until_done()}
    return jeng, teng, jout, tout


def check_streams(jeng, teng, jout, tout, new_tokens):
    assert tout == jout
    assert len(tout) == 4 and all(len(o) == new_tokens for o in tout.values())
    snap, jsnap = teng.metrics.snapshot(), jeng.metrics.snapshot()
    assert snap["prefix_hit_tokens"] == jsnap["prefix_hit_tokens"]
    assert snap["preemptions"] == jsnap["preemptions"]
    pins = teng.prefix_cache.pages() if teng.prefix_cache is not None else None
    assert teng.pool.assert_consistent(known_pins=pins) == []
    return snap


@pytest.mark.parametrize("case", list(CASES))
def test_engine_token_streams_match_jax(case):
    t_backend, fused, j_backend, serve_kw, new_tokens = CASES[case]
    jeng, teng, jout, tout = serve_both("llama3.2-3b", t_backend, fused,
                                        j_backend, serve_kw, new_tokens)
    snap = check_streams(jeng, teng, jout, tout, new_tokens)
    if case == "monolithic":
        assert teng.prefix_cache is None and snap["prefix_hit_tokens"] == 0
    else:
        # the shared 150 tokens install as 9 whole pages; the next chunk
        # starts at 144, off the 64-token query block (resumed sequences
        # hit their own prompts' pages too)
        hits = snap["prefix_hit_tokens"]
        assert hits == 144 if "pool_pages" not in serve_kw else hits > 144
        assert teng.scheduler.chunk_align == 1
    assert (snap["preemptions"] > 0) == ("pool_pages" in serve_kw)
    assert teng.model.use_sparse(teng.max_context) == (case != "inactive")
