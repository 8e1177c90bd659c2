"""Serving the recurrent families in the port against JAX's engine on the
CPU, at temperature 0: recurrentgemma-9b (5 layers: a cycle of (rglru,
rglru, local_attn) and two remainder rglru layers, window 64) and
rwkv6-3b, smoke variants in float32, the port on the ``"cuda"`` backend
with the fused decode (the repo's default serving configuration).

Four prompts of 96 tokens (two sharing their first 64; one length, so
JAX compiles one prefill) x 24 new tokens on two slots, so every slot is
reused; the JAX engine is wrapped by ``_jax_slot_reset.
clear_slots_on_install``, as every port engine test does.  The streams
must be token identical.  Both engines prefill in one shot:
``_chunkable`` is False with ``prefill_chunk`` > 0 (the models do not
support chunked prefill), there is no prefix cache, the plan is inactive
and no kernel nor its plain version runs.  The decodes cross
recurrentgemma's window (96 + 24 > 64).

About 40 s in one process (JAX compiles its recurrent prefill and
decode).
"""
import dataclasses

import numpy as np
import pytest

import test_torch_dense_engine as dense_engine
from repro_torch import kernels

from test_torch_dense_engine import check_streams, serve_both
from test_torch_dense_family import _one_thread  # noqa: F401

NEW_TOKENS = 24
LAYERS = {"recurrentgemma-9b": 5, "rwkv6-3b": 2}


def _prompts(vocab=256):
    rng = np.random.default_rng(12)
    shared = rng.integers(0, vocab, 64)
    return [np.concatenate([shared, rng.integers(0, vocab, 32)]),
            np.concatenate([shared, rng.integers(0, vocab, 32)]),
            rng.integers(0, vocab, 96), rng.integers(0, vocab, 96)]


@pytest.mark.parametrize("arch", list(LAYERS))
def test_engine_streams_match_jax(arch, monkeypatch):
    monkeypatch.setattr(dense_engine, "prompts", _prompts)
    kernels.reset_counts()
    jeng, teng, jout, tout = serve_both(
        arch, "cuda", True, "reference", {}, NEW_TOKENS,
        adjust=lambda c: dataclasses.replace(c, n_layers=LAYERS[arch]))
    check_streams(jeng, teng, jout, tout, NEW_TOKENS)
    assert teng.serve.prefill_chunk > 0 and teng.serve.max_batch == 2
    assert not teng._chunkable and not jeng._chunkable
    assert teng.prefix_cache is None and jeng.prefix_cache is None
    assert not teng.model.use_sparse(teng.max_context)
    assert teng.metrics.snapshot()["prefix_hit_tokens"] == 0
    assert all(c == {"launches": 0, "plain_calls": 0} for c in kernels.counts().values())
    assert len({t for o in tout.values() for t in o}) > 4
