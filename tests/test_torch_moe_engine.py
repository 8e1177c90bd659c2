"""Serving parity of the MoE family with the JAX engine, on the CPU.

Both engines serve granite-moe-3b-a800m's smoke variant (float32, 4
experts top-2, fixed non-uniform block sizes) at temperature 0 through
``test_torch_dense_engine.serve_both`` (the JAX engine wrapped in
``_jax_slot_reset.clear_slots_on_install``): four prompts, two sharing a
150-token prefix, chunks of 128, a page pool of 22 pages, so the prefix
cache installs 144 tokens and sequences are preempted and replay their
tokens.  Once at the smoke variant's lossless capacity and once at the
published capacity factor 1.25, where a chunk buffer of 128 tokens has 80
places an expert, so picks are dropped at every chunk boundary as JAX
drops them.  Token streams identical, prefix hits and preemptions equal
to JAX's, the port's page pool clean at drain.
"""
import dataclasses

import pytest

import test_torch_dense_engine as dense_engine
from test_torch_dense_engine import check_streams, serve_both
from test_torch_dense_family import BLOCK_SIZES, _one_thread  # noqa: F401
from test_torch_step_graph import stub_graphs  # noqa: F401

from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

ARCH = "granite-moe-3b-a800m"
NEW_TOKENS = 32


def published_capacity(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))


@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "capacity-1.25"])
def test_engine_token_streams_match_jax(lossy, monkeypatch):
    monkeypatch.setitem(dense_engine.SPARSE, "block_sizes", BLOCK_SIZES[2])
    dropped = []
    orig = tmoe.moe_ffn

    def counting(*args, **kw):
        routing = {}
        y = orig(*args, routing=routing, **kw)
        dropped.append(int((~routing["kept"]).sum()))
        return y

    monkeypatch.setattr(tlayers, "moe_ffn", counting)
    jeng, teng, jout, tout = serve_both(
        ARCH, "cuda", True, "reference", {"pool_pages": 22}, NEW_TOKENS,
        adjust=published_capacity if lossy else None)
    snap = check_streams(jeng, teng, jout, tout, NEW_TOKENS)
    assert teng.cfg.moe.capacity_factor == (1.25 if lossy else 2.0)
    assert snap["prefix_hit_tokens"] > 144 and snap["preemptions"] > 0
    assert (sum(dropped) > 0) == lossy


def test_launcher_serves_granite(capsys):
    """``python -m repro_torch.launch.serve --arch granite-moe-3b-a800m
    --smoke`` serves to the end on the CPU."""
    from repro_torch.launch import serve as tserve

    eng = tserve.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--fused-decode",
        "--sparse-prefill", "--requests", "3", "--max-context", "512",
        "--max-batch", "2", "--prefill-chunk", "128", "--new-tokens", "4",
        "--prefix-len", "64"])
    out = capsys.readouterr().out
    assert eng.model.cfg.name == f"{ARCH}-smoke" and eng.model.cfg.moe.n_experts == 4
    assert [len(r.output) for r in eng.finished] == [4, 4, 4]
    assert all(r.status == "ok" for r in eng.finished)
    assert "served 3 requests / 12 tokens" in out and "accounting clean" in out


def test_granite_decode_step_is_capturable(stub_graphs):
    """granite's smoke decode step (fused, the published capacity factor)
    reads nothing on the host (``NoHostSync``: no ``.item()``, ``nonzero``
    or boolean indexing in the MoE FFN), and through ``DecodeGraph`` (the
    capture stubbed as in ``test_torch_step_graph``) gives the eager
    step's logits and cache bitwise."""
    import torch

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import Transformer
    from repro_torch.serving import DecodeGraph
    from test_torch_step_graph import LENS, NoHostSync, _assert_same, _cache, _state

    base = published_capacity(smoke_variant(get_config(ARCH)))
    cfg = dataclasses.replace(base, sparse=dataclasses.replace(
        base.sparse, backend="cuda", fused_decode=True, token_budget=128,
        block_sizes=BLOCK_SIZES[2]))
    model = Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    cache = _cache(model, 512, False)
    tokens = torch.tensor([5, 17])
    with NoHostSync():
        want = model.decode_step(cache, tokens)[0].clone()
    state = _state(cache)
    graph = DecodeGraph(model.decode_step, cache)
    for _ in range(2):
        cache["seq_len"].copy_(torch.tensor(LENS, dtype=torch.int32))
        logits, _ = graph(cache, tokens)
        assert torch.equal(logits, want)
        _assert_same(state, _state(cache))
