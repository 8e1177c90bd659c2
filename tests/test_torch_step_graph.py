"""The engine's compiled decode step (``repro_torch.serving.graphs``) on the
CPU.

A CUDA graph replays a step captured over the live cache, so the step must
be idempotent for given ``(cache["seq_len"], tokens)``, read its tokens
from a buffer refilled in place and its lengths only from
``cache["seq_len"]``, and make no host sync.  Those properties are held
here at smoke width for every capturable decode (fused, staged, the
``"dense"`` backend, the inactive plan), with telemetry on and off.

A stub of the capture (``graphs._capture`` and the side stream; no CUDA
here) then makes ``DecodeGraph`` run on the CPU: the stub runs the captured
function once under a mode that refuses host syncs, as a capture would,
and each replay calls it again on the static buffers and copies its logits
into the static output, counting nothing.  With it the engine serves the
default configuration as JAX does, the three-rung ladder of
``tests/test_torch_resilience.py`` runs with each tick's kernel counts
equal to the eager engine's, a tiered engine stalls and re-runs a step on
its graph as the eager one does, and the guards raise (tiered memory's
page masks among the tensors a graph is bound to).
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.config import ServeConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import Transformer
from repro_torch.serving import DecodeGraph, Engine, Request, step_graphs_disabled
from repro_torch.serving import graphs
from repro_torch.serving.probe import TIER_COUNTERS, LadderProbe, demote_around_shield
from repro_torch.serving.scheduler import DECODE

from test_torch_dense_engine import check_streams, serve_both
from test_torch_resilience import FAILURE_KEYS, FLEET_KEYS, _ladder_engine

B = 2
#: decode kind -> (sparse overrides, max_context): an inactive plan at 200
#: (under twice the budget, no multiple of the page size)
KINDS = {
    "fused": (dict(backend="cuda", fused_decode=True), 512),
    "staged": (dict(backend="cuda", fused_decode=False), 512),
    "dense": (dict(backend="dense", fused_decode=False), 512),
    "inactive": (dict(backend="cuda", fused_decode=True), 200),
}
LENS = (150, 83)
#: ops that read device memory on the host (``.item()``, ``bool(t)``,
#: ``tolist``) or size an output from data (boolean-mask indexing)
HOST_SYNCS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
              "aten.unique", "aten._unique")


class NoHostSync(TorchDispatchMode):
    """Raises on any op that a CUDA graph capture cannot record."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(HOST_SYNCS):
            raise RuntimeError(f"host sync in a captured step: {func}")
        return func(*args, **(kwargs or {}))


class FakeGraph:
    """A replay: the captured function again, its logits copied into the
    static output, the kernel counts left as they were (a replay runs no
    Python; ``DecodeGraph`` adds the captured step's counts)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        before = kernels.counts()
        self.out.copy_(self.fn())
        kernels.reset_counts()
        kernels.add_counts(before)


def fake_capture(fn, pool, device):
    with NoHostSync():
        out = fn()
    return FakeGraph(fn, out), out


@pytest.fixture
def stub_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "graph_device", lambda device: True)
    monkeypatch.setattr(graphs, "new_pool", lambda: object())
    monkeypatch.setattr(graphs, "_on_side_stream", lambda fn, device: fn())
    monkeypatch.setattr(graphs, "_capture", fake_capture)


def _model(kind):
    overrides, ctx = KINDS[kind]
    base = smoke_variant(get_config("llama3.2-3b"))
    cfg = dataclasses.replace(base, sparse=dataclasses.replace(
        base.sparse, token_budget=128, block_sizes=((16, 32), (64, 16)),
        **overrides))
    return Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(0)), ctx


def _cache(model, ctx, telemetry, seed=0):
    """Random K/V (numpy ``seed``), stores rebuilt from them, ragged
    lengths ``LENS``."""
    rng = np.random.default_rng(seed)
    cache = model.init_cache(B, ctx)
    for e in cache["layers"]:
        for name in ("k", "v"):
            e[name].copy_(torch.from_numpy(
                rng.standard_normal(e[name].shape).astype(np.float32)))
    for slot in range(B):
        model.refresh_slot_store(cache, slot)
    cache["seq_len"].copy_(torch.tensor(LENS, dtype=torch.int32))
    if telemetry:
        cache["_telemetry"] = torch.zeros((model.cfg.n_layers, B, 4),
                                          dtype=torch.int32)
    return cache


def _state(cache):
    """Every tensor the step may write, cloned."""
    out = {"seq_len": cache["seq_len"].clone()}
    if "_telemetry" in cache:
        out["_telemetry"] = cache["_telemetry"].clone()
    for l, e in enumerate(cache["layers"]):
        out.update({f"{l}.{k}": v.clone() for k, v in e.items()})
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


CASES = [(k, t) for k in KINDS for t in (False, True)]
IDS = [f"{k}{'-telemetry' if t else ''}" for k, t in CASES]


# -- the step's properties ---------------------------------------------------


@pytest.mark.parametrize("kind,telemetry", CASES, ids=IDS)
def test_decode_step_is_idempotent(kind, telemetry):
    """Two steps from one ``(seq_len, tokens)`` give bitwise equal logits
    and leave every cache tensor equal (what warm-up, capture and a
    degraded re-run rely on); the step advances ``seq_len`` by one."""
    model, ctx = _model(kind)
    cache = _cache(model, ctx, telemetry)
    tokens = torch.tensor([5, 17])
    runs = []
    for _ in range(2):
        cache["seq_len"].copy_(torch.tensor(LENS, dtype=torch.int32))
        logits, out = model.decode_step(cache, tokens)
        assert out is cache and logits.shape == (B, model.cfg.vocab_size)
        runs.append((logits.clone(), _state(cache)))
    assert torch.equal(runs[0][0], runs[1][0])
    _assert_same(runs[0][1], runs[1][1])
    assert runs[0][1]["seq_len"].tolist() == [n + 1 for n in LENS]


@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_step_reads_static_buffers(kind):
    """The step makes no host sync, takes its tokens from a device buffer
    refilled in place and its lengths only from ``cache["seq_len"]``: new
    tokens and lengths written into the same tensors give what a fresh
    step on fresh tensors gives."""
    model, ctx = _model(kind)
    cache = _cache(model, ctx, telemetry=True)
    fresh = _cache(model, ctx, telemetry=True)
    buf = torch.zeros((B,), dtype=torch.int64)
    for toks, lens in (((5, 17), LENS), ((200, 3), (40, 151))):
        buf.copy_(torch.tensor(toks))
        cache["seq_len"].copy_(torch.tensor(lens, dtype=torch.int32))
        with NoHostSync():
            logits, _ = model.decode_step(cache, buf)
        fresh["seq_len"] = torch.tensor(lens, dtype=torch.int32)
        want, _ = model.decode_step(fresh, torch.tensor(toks))
        assert torch.equal(logits, want)
        _assert_same(_state(cache), _state(fresh))


# -- DecodeGraph through the stub -------------------------------------------------


@pytest.mark.parametrize("kind,telemetry", CASES, ids=IDS)
def test_graph_matches_eager_step(stub_graphs, kind, telemetry):
    """The first call (warm-up, capture, replay) and a later replay give
    the eager step's logits and cache bytes; warm-up and capture leave the
    kernel counts as they were and each replay adds one step's."""
    model, ctx = _model(kind)
    eager, cache = _cache(model, ctx, telemetry), _cache(model, ctx, telemetry)
    tokens = torch.tensor([5, 17])
    kernels.reset_counts()
    want, _ = model.decode_step(eager, tokens)
    one_step = kernels.counts()
    graph = DecodeGraph(model.decode_step, cache)
    for calls in (1, 2):
        kernels.reset_counts()
        cache["seq_len"].copy_(torch.tensor(LENS, dtype=torch.int32))
        logits, out = graph(cache, tokens.numpy())
        assert out is cache and torch.equal(logits, want)
        _assert_same(_state(cache), _state(eager))
        assert kernels.counts() == one_step and graph.replays == calls


def test_graph_guards(stub_graphs):
    """A graph replays only over the cache dict and tensors it captured,
    with telemetry as it was."""
    model, ctx = _model("fused")
    cache = _cache(model, ctx, telemetry=False)
    graph = DecodeGraph(model.decode_step, cache)
    graph(cache, torch.tensor([1, 2]))
    with pytest.raises(RuntimeError, match="another cache"):
        graph(dict(cache), torch.tensor([1, 2]))
    cache["_telemetry"] = torch.zeros((model.cfg.n_layers, B, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="telemetry"):
        graph(cache, torch.tensor([1, 2]))
    del cache["_telemetry"]
    graph(cache, torch.tensor([1, 2]))
    cache["layers"][1]["k"] = cache["layers"][1]["k"].clone()
    with pytest.raises(RuntimeError, match="replaced"):
        graph(cache, torch.tensor([1, 2]))


def test_host_sync_fails_the_capture(stub_graphs):
    """A step that reads device memory on the host cannot be captured: the
    call raises, nothing falls back to the eager step."""
    model, ctx = _model("fused")
    cache = _cache(model, ctx, telemetry=False)

    def step(cache, tokens):
        int(cache["seq_len"][0].item())
        return model.decode_step(cache, tokens)

    with pytest.raises(RuntimeError, match="host sync"):
        DecodeGraph(step, cache)(cache, torch.tensor([1, 2]))


def test_graph_needs_a_cuda_device():
    model, ctx = _model("fused")
    with pytest.raises(RuntimeError, match="cannot be captured"):
        DecodeGraph(model.decode_step, model.init_cache(B, ctx))


def _engine(model, ctx):
    eng = Engine(model.cfg, model, ServeConfig(
        max_batch=B, max_context=ctx, prefill_chunk=128, temperature=0.0),
        device="cpu")
    eng.submit(Request(0, np.arange(90, dtype=np.int32) % 256, max_new_tokens=3))
    return eng


def test_engine_hands_out_graphs(stub_graphs):
    """Kernel rungs get a ``DecodeGraph``, the plain ``"reference"`` backend
    and engines built under ``step_graphs_disabled()`` the bound method;
    dropping the engine frees its graphs."""
    model, ctx = _model("fused")
    with step_graphs_disabled():
        eager = _engine(model, ctx)
    assert eager._rung_step_fns(0)[0] == model.decode_step
    ref = model.with_sparse(backend="reference", fused_decode=False)
    assert _engine(ref, ctx)._rung_step_fns(0)[0] == ref.decode_step
    eng = _engine(model, ctx)
    graph = eng._rung_step_fns(0)[0]
    assert isinstance(graph, DecodeGraph) and eng._rung_step_fns(0)[0] is graph
    done = eng.run_until_done(max_ticks=50)
    assert len(done[0].output) == 3 and graph.replays == 2
    alive = weakref.ref(graph)
    del eng, graph
    gc.collect()
    assert alive() is None


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_graphed_engine_matches_jax(stub_graphs, fused):
    """The default configuration (dense chunked prefill, sparse decode)
    served with a graphed decode step: streams, prefix hits and
    preemptions equal to JAX's, and every decode step a replay."""
    probes = []
    jeng, teng, jout, tout = serve_both(
        "llama3.2-3b", "cuda", fused, "reference", {}, 5,
        attach=lambda eng: probes.append(LadderProbe(eng)))
    check_streams(jeng, teng, jout, tout, 5)
    steps = [k for st in probes[0].steps.values() for _, k, _ in st].count("decode")
    assert set(teng._step_graphs) == {0} and teng._step_graphs[0].replays == steps > 0
    probes[0].detach()


def test_graphed_ladder_counts_as_eager(stub_graphs):
    """The three-rung ladder plan of ``test_ladder_degrades_and_repromotes``
    on graphs: the same tokens, counters and, tick by tick, the same kernel
    counts as the eager engine; the fused and staged rungs replay one graph
    each (one replay per decode step), the reference rung runs eagerly."""
    model = _model("fused")[0]
    tcfg = smoke_variant(get_config("llama3.2-3b"))
    plan = [dict(site="prefill", tick=0, count=1),
            dict(site="decode", tick=2, count=1),
            dict(site="decode_nan", tick=7, seq_id=1, count=1)]
    runs = {}
    for name in ("eager", "graphed"):
        ticks, probes = [], []

        def callback(eng, tick):
            probes[0](eng, tick)
            ticks.append(kernels.counts())

        def attach(eng):
            probes.append(LadderProbe(eng))
            kernels.reset_counts()

        if name == "eager":
            with step_graphs_disabled():
                eng, reqs = _ladder_engine(tcfg, model, plan=plan, repromote_after=3,
                                           attach=attach, tick_callback=callback)
        else:
            eng, reqs = _ladder_engine(tcfg, model, plan=plan, repromote_after=3,
                                       attach=attach, tick_callback=callback)
        probes[0].detach()
        runs[name] = (eng, reqs, ticks, probes[0])
    (e_eng, e_reqs, e_ticks, _), (g_eng, g_reqs, g_ticks, probe) = (
        runs["eager"], runs["graphed"])
    assert [r.output for r in g_reqs] == [r.output for r in e_reqs]
    snaps = [{k: e.metrics.snapshot()[k] for k in FAILURE_KEYS + FLEET_KEYS}
             for e in (e_eng, g_eng)]
    assert snaps[0] == snaps[1]
    assert snaps[1]["degradations_by_rung"] == {"staged": 1, "reference": 2}
    assert g_ticks == e_ticks
    assert not e_eng._step_graphs and set(g_eng._step_graphs) == {0, 1}
    decodes = {}
    for st in probe.steps.values():
        for r, k, _ in st:
            decodes[r] = decodes.get(r, 0) + (k == "decode")
    assert decodes.keys() == {0, 1, 2}
    for rung, graph in g_eng._step_graphs.items():
        assert graph.replays == decodes[rung] > 0


def _plant_masks(cache, ctx):
    for key in ("_sel_pages", "_pre_pages"):
        cache[key] = torch.zeros((B, ctx // 16), dtype=torch.bool)


def test_graph_tensors_cover_the_page_masks(stub_graphs):
    """Tiered memory's planted page masks are among the tensors a graph is
    bound to: a graphed step fills them as the eager step does, and
    planting, removing or replacing them after the capture raises."""
    model, ctx = _model("fused")
    cache, eager = _cache(model, ctx, False), _cache(model, ctx, False)
    for c in (cache, eager):
        _plant_masks(c, ctx)
    held = graphs._tensors(cache)
    assert any(t is cache["_sel_pages"] for t in held)
    assert any(t is cache["_pre_pages"] for t in held)
    tokens = torch.tensor([1, 2])
    want, _ = model.decode_step(eager, tokens)
    graph = DecodeGraph(model.decode_step, cache)
    cache["seq_len"].copy_(torch.tensor(LENS, dtype=torch.int32))
    logits, _ = graph(cache, tokens)
    assert torch.equal(logits, want)
    for key in ("_sel_pages", "_pre_pages"):
        assert torch.equal(cache[key], eager[key]) and bool(cache[key].any())
    assert bool((cache["_pre_pages"] | ~cache["_sel_pages"]).all())
    sel = cache.pop("_sel_pages")
    with pytest.raises(RuntimeError, match="_sel_pages"):
        graph(cache, tokens)
    cache["_sel_pages"] = sel.clone()
    with pytest.raises(RuntimeError, match="replaced"):
        graph(cache, tokens)
    bare = _cache(model, ctx, False)
    graph = DecodeGraph(model.decode_step, bare)
    graph(bare, tokens)
    _plant_masks(bare, ctx)
    with pytest.raises(RuntimeError, match="planted"):
        graph(bare, tokens)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_graphed_tiered_engine_matches_eager(stub_graphs, fused):
    """An overcommitted tiered engine with a forced miss (request 0's sink
    page demoted around the shield once it decodes): graphed and eager give
    the same tokens and tiering counters, the stalled step re-runs on the
    graph (every decode step a replay), and the tokens equal a flat
    pool's."""
    model, ctx = _model("fused" if fused else "staged")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, 300).astype(np.int32) for _ in range(3)]
    runs = {}
    for name in ("eager", "graphed", "flat"):
        pool = dict(pool_pages=96) if name == "flat" else dict(hbm_pages=40,
                                                               host_pages=60)
        serve = ServeConfig(max_batch=4, max_context=ctx, temperature=0.0,
                            prefill_tokens_per_tick=512, **pool)
        if name == "eager":
            with step_graphs_disabled():
                eng = Engine(model.cfg, model, serve, device="cpu")
        else:
            eng = Engine(model.cfg, model, serve, device="cpu")
        reqs = [Request(i, p, max_new_tokens=12) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        probe = LadderProbe(eng)
        forced = name == "flat"
        for _ in range(300):
            if not eng.scheduler.has_work:
                break
            seq = eng.scheduler.running.get(0)
            if not forced and seq is not None and seq.state == DECODE and len(
                    seq.req.output) >= 2:
                forced = demote_around_shield(eng, 0) is not None
            eng.step()
            probe(eng, eng.metrics.ticks)
        probe.detach()
        assert forced and all(r.done for r in reqs)
        assert eng.pool.assert_consistent(known_pins=eng.prefix_cache.pages()) == []
        runs[name] = (eng, [list(r.output) for r in reqs], probe)
    snaps = {n: runs[n][0].metrics.snapshot() for n in ("eager", "graphed")}
    tier = {n: {k: s[k] for k in TIER_COUNTERS} for n, s in snaps.items()}
    assert runs["graphed"][1] == runs["eager"][1] == runs["flat"][1]
    assert tier["graphed"] == tier["eager"] and tier["graphed"]["stalls"] >= 1
    assert runs["graphed"][0].pool.demotions > 0
    steps = [k for st in runs["graphed"][2].steps.values() for _, k, _ in st]
    assert runs["graphed"][0]._step_graphs[0].replays == steps.count("decode") > 0
