"""Tracing of the port (``repro_torch.obs``: the recorder, the validator,
the cost model; the engine's, the metrics' and the prefix cache's trace
hooks) against the JAX package's (``repro.obs``), on the CPU.

- The recorders export the same Chrome JSON for the same calls on the same
  virtual clock (ring eviction and ``dropped`` included); the validators
  give the same verdicts on good and corrupt traces, and their command
  lines the same exit codes and output; the cost models give the same
  numbers for both registered configs.
- ``ServingMetrics``' lifecycle spans and instants, and its
  ``format_snapshot``, equal JAX's for the same hook calls.
- Engines: the JAX engine and the port's serve the smoke variant of
  llama3.2-3b with the same weights (``params_from_jax``), the same
  requests and the same clock (the tick counter).  Their exported traces
  are equal event for event once ``ts`` and ``dur`` are removed (name,
  phase, pid, tid, args, order and the metadata events), and both
  validators accept both: (a) sparse prefill, the prefix cache and
  preemption on a tight flat pool; (b) tiered memory, overcommitted, with
  stalls, demotions, promotions and prefetches; (c) a fault storm on a
  tiered pool with a two-rung ladder (degrade, re-promote, retry, restore,
  watchdog, host-I/O errors, the starvation breaker).
- ``set_tracing`` attaches, detaches and re-attaches on a live engine as
  JAX's does (``tests/test_obs.py``), with the tokens of a never-traced
  engine; graphed (the capture stubbed, as ``tests/test_torch_step_graph.py``
  does), each telemetry variant of the decode step is captured once and
  replayed after every toggle.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _jax_slot_reset import clear_slots_on_install
from repro import obs as jobs
from repro import resilience as jres
from repro.config import ResilienceConfig as JRes
from repro.config import ServeConfig as JServe
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.models import Transformer as JTransformer
from repro.obs import validate as jvalidate
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving.metrics import ServingMetrics as JMetrics

from repro_torch import obs as tobs
from repro_torch import resilience as tres
from repro_torch.config import ResilienceConfig as TRes
from repro_torch.config import ServeConfig as TServe
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.obs import validate as tvalidate
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving.metrics import ServingMetrics as TMetrics

from test_torch_step_graph import stub_graphs  # noqa: F401 (a fixture)

PKGS = {"jax": jobs, "torch": tobs}
#: sparse prefill and an active plan at max_context 512
SPARSE = dict(token_budget=128, block_sizes=((16, 32), (64, 16)),
              sparse_prefill=True, prefill_block_q=64)
SPANS = ["engine.tick", "engine.decode", "prefill.chunk", "seq.queued",
         "seq.prefill", "seq.decode"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU ops on one thread: the suite runs in parallel
    workers, and torch's default pool (a thread per core in every worker)
    oversubscribes the cores and slows these small ops several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    """Deterministic monotonic clock: every read advances by ``step``."""

    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _strip(trace):
    """The exported events without their times."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in trace["traceEvents"]]


# -- the recorder, the validator, the cost model ------------------------------------


def _record_ops(o, capacity):
    """The same calls on ``o``'s recorder -> (export, dropped, len, names)."""
    rec = o.TraceRecorder(capacity=capacity, clock=FakeClock(0.25))
    pending = []
    rec.add_flush_hook(lambda: [rec.counter_at("late", v, ts, pid=o.PID_KERNEL)
                                for ts, v in pending])
    rec.name_thread(o.PID_SEQ, 3, "req 3")
    rec.name_thread(o.PID_SEQ, 3, "renamed")          # first name sticks
    with rec.span("outer", o.PID_ENGINE, args={"tick": 0}):
        rec.begin("seq.decode", o.PID_SEQ, 3, args={"a": 1})
        with rec.span("inner", o.PID_ENGINE):
            rec.instant("mark", o.PID_SCHED, args={"seq": 3})
        rec.counter("pool", {"used_pages": 3, "free_pages": 5})
        pending.append((rec.clock(), {"blocks": 7}))
        rec.end("seq.decode", o.PID_SEQ, 3)
    for i in range(6):
        rec.instant(f"ev{i}", o.PID_MEMORY, tid=i % 2)
    out = rec.to_chrome()
    return out, rec.dropped, len(rec), [e.name for e in rec.events()]


@pytest.mark.parametrize("capacity", [64, 5], ids=["roomy", "evicting"])
def test_recorder_exports_as_jax(capacity, tmp_path):
    """Spans, begin / end, instants, counters, a deferred counter of a flush
    hook and thread names export to the same JSON, with the same ring
    eviction and ``dropped`` count."""
    got = {pkg: _record_ops(o, capacity) for pkg, o in PKGS.items()}
    assert got["torch"] == got["jax"]
    out, dropped, n, _ = got["torch"]
    assert (dropped > 0) == (capacity == 5) and n == min(capacity, n + dropped)
    assert out["otherData"] == {"dropped_events": dropped, "capacity": capacity}
    for pkg, o in PKGS.items():
        rec = o.TraceRecorder(clock=FakeClock())
        rec.instant("x", o.PID_ENGINE)
        rec.dump(str(tmp_path / f"{pkg}.json"))
    assert (tmp_path / "torch.json").read_text() == (tmp_path / "jax.json").read_text()
    assert {(k, getattr(tobs, k)) for k in tobs.__all__ if k.startswith("PID_")} == {
        (k, getattr(jobs, k)) for k in jobs.__all__ if k.startswith("PID_")}
    assert sorted(tobs.__all__) == sorted(jobs.__all__)


def _traces():
    """(trace, require_spans, require_counters, require_instants): good and
    corrupt traces."""
    good = jobs.TraceRecorder(clock=FakeClock())
    good.begin("seq.decode", jobs.PID_SEQ, 1)
    good.counter("pool", {"used_pages": 3, "free_pages": 5})
    good.instant("sched.admit", jobs.PID_SCHED)
    good.end("seq.decode", jobs.PID_SEQ, 1)
    g = good.to_chrome()
    events = g["traceEvents"]
    out = [(g, ["seq.decode"], ["pool"], ["sched.admit"]),
           (g, ["nope"], ["nope"], ["nope"]),
           ([], (), (), ()),
           ({"traceEvents": "x"}, (), (), ())]
    dangling = dict(g, traceEvents=events + [
        {"name": "seq.stall", "ph": "B", "ts": 9.0, "pid": 4, "tid": 1}])
    out.append((dangling, (), (), ()))
    for bad in ({"name": "e", "ph": "E", "ts": 1.0, "pid": 4, "tid": 1},
                {"name": "x", "ph": "X", "ts": 1.0, "pid": 2, "tid": 0, "dur": -1},
                {"name": "x", "ph": "X", "ts": 1.0, "pid": 2, "tid": 0},
                {"name": "q", "ph": "Q", "ts": 1.0, "pid": 2, "tid": 0},
                {"name": "c", "ph": "C", "ts": 1.0, "pid": 3, "tid": 0, "args": {}},
                {"name": "t", "ph": "i", "ts": "late", "pid": 3, "tid": 0},
                {"name": "m", "ph": "i", "pid": 3},
                "not an event"):
        out.append((dict(g, traceEvents=events + [bad]), (), (), ()))
        evicted = dict(g, traceEvents=events + [bad],
                       otherData={"dropped_events": 3, "capacity": 8})
        out.append((evicted, (), (), ()))
    crossed = jobs.TraceRecorder(clock=FakeClock())
    crossed.begin("seq.prefill", jobs.PID_SEQ, 1)
    crossed.begin("seq.stall", jobs.PID_SEQ, 1)
    crossed.end("seq.prefill", jobs.PID_SEQ, 1)
    out.append((crossed.to_chrome(), (), (), ()))
    return out


def test_validators_agree_with_jax(tmp_path, capsys):
    """The same violations, in the same words, for every trace; the command
    lines exit and print alike."""
    verdicts = []
    for trace, spans, counters, instants in _traces():
        v = tvalidate.validate_chrome_trace(trace, spans, counters, instants)
        assert v == jvalidate.validate_chrome_trace(trace, spans, counters, instants)
        verdicts.append(bool(v))
    assert verdicts[0] is False and verdicts.count(False) >= 3 and sum(verdicts) >= 10
    trace, spans, counters, instants = _traces()[0]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    for extra in ([], ["--require", "nope", "--instant", "nope"]):
        argv = [str(path), "--require", "seq.decode", "--counter", "pool",
                "--instant", "sched.admit"] + extra
        codes = [m.main(argv) for m in (tvalidate, jvalidate)]
        out = capsys.readouterr().out.splitlines()
        assert codes[0] == codes[1] == (1 if extra else 0)
        assert out[:len(out) // 2] == out[len(out) // 2:]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-8b"])
def test_cost_model_matches_jax(arch):
    """``decode_kernel_cost`` and ``prefill_kernel_cost`` give JAX's numbers
    exactly, for the full config and its smoke variant, at several
    contexts, batches and chunk sizes."""
    for cfgs in ((t_get_config(arch), j_get_config(arch)),
                 (t_smoke(t_get_config(arch)), j_smoke(j_get_config(arch)))):
        tcfg, jcfg = cfgs
        assert tcfg.attn_layers == jcfg.attn_layers
        for ctx in (256, 4096, 9000, 16384, 65536, 131072):
            for batch in (1, 4):
                assert tobs.decode_kernel_cost(tcfg, ctx, batch) == \
                    jobs.decode_kernel_cost(jcfg, ctx, batch)
                for chunk in (64, 512):
                    assert tobs.prefill_kernel_cost(tcfg, ctx, chunk, batch) == \
                        jobs.prefill_kernel_cost(jcfg, ctx, chunk, batch)


# -- ServingMetrics ---------------------------------------------------------------------


def _metrics_events(Metrics, o):
    clock = FakeClock()
    m = Metrics(clock=clock)
    m.trace = o.TraceRecorder(clock=clock)
    m.on_submit(7, prompt_tokens=100, slo_class="batch")
    m.on_submit(8, prompt_tokens=64)
    m.on_prefix_defer(8)
    m.on_admit(7, prefix_hit_tokens=32)
    m.on_admit(8)
    m.on_first_token(7)
    m.on_decode_token(7)
    m.on_stall_begin(7)
    m.on_stall_begin(7)                  # one stall span open at a time
    m.on_prefetch_miss(2)
    m.on_migration(4096, demote=False)
    m.on_preempt(7)                      # closes the stall, then decode
    m.on_stall_end(7)                    # no-op: already closed
    m.on_admit(7)
    m.on_first_token(7)
    m.on_stall_begin(7)
    m.on_stall_end(7)
    m.on_prefetch_hit(3)
    m.on_prefetch_staged(1)
    m.on_migration(4096, demote=True)
    m.set_residency(10, 4)
    m.on_decode_token(7)
    m.on_finish(7)
    m.on_finish(7)                       # idempotent
    m.on_first_token(8)
    m.on_retry(8, "sampler_anomaly")
    m.on_restore(8)
    m.on_degrade("staged", "device_error")
    m.on_repromote("fused")
    m.on_watchdog(8)
    m.on_host_io_error("promote")
    m.on_admit(8)
    m.on_request_failed(8, "device_error")
    m.ticks = 5
    return m.trace.to_chrome(), m.format_snapshot(), m.snapshot()


def test_metrics_trace_and_format_as_jax():
    """Every lifecycle span and instant of the ``on_*`` hooks, in order, and
    ``format_snapshot`` equal JAX's for the same calls."""
    t_trace, t_text, t_snap = _metrics_events(TMetrics, tobs)
    j_trace, j_text, j_snap = _metrics_events(JMetrics, jobs)
    assert t_trace == j_trace
    t_events = _strip(t_trace)
    assert t_text == j_text and "stalls=3" in t_text
    assert t_snap == j_snap
    names = {e["name"] for e in t_events}
    assert {"seq.queued", "seq.prefill", "seq.decode", "seq.stall", "prefix.hit",
            "prefix.defer", "seq.preempt", "prefetch.hit", "prefetch.miss",
            "prefetch.stage", "mem.demote", "mem.promote", "seq.retry",
            "seq.restore", "engine.degrade", "engine.repromote", "engine.watchdog",
            "mem.io_error", "seq.failed"} <= names
    assert tobs.validate_chrome_trace(t_trace) == []


# -- engines, event for event -------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, JAX params, port cfg, port model): smoke llama3.2-3b with
    ``SPARSE``, the port's on the ``"cuda"`` backend (the kernels' plain
    versions here)."""
    jb, tb = j_smoke(j_get_config("llama3.2-3b")), t_smoke(t_get_config("llama3.2-3b"))
    jcfg = dataclasses.replace(jb, sparse=dataclasses.replace(
        jb.sparse, backend="reference", **SPARSE))
    tcfg = dataclasses.replace(tb, sparse=dataclasses.replace(
        tb.sparse, backend="cuda", **SPARSE))
    params = JTransformer(jcfg).init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


#: the reference rung the port's ladder ends in (JAX builds it lazily from
#: these overrides)
_REF = {"backend": "reference", "fused_decode": False, "sparse_prefill": False}


def _engine(pkg, setup, serve, fused=True, res=None, ladder=False, trace=True):
    """A traced engine of ``pkg`` whose clocks read its tick counter.  With
    ``ladder`` the port decodes staged (rungs staged -> reference) and JAX's
    engine, whose ``"reference"`` backend has one rung, is given the same
    two (its rung 0 the configured backend, its rung 1 built from
    ``_REF``); nothing in ``src/repro`` changes."""
    jcfg, params, tcfg, model = setup
    box = {}
    clock = lambda: float(box["eng"].metrics.ticks)      # noqa: E731
    serve = dict(serve, temperature=0.0)
    if pkg == "jax":
        if res is not None:
            serve["resilience"] = JRes(**res)
        rec = jobs.TraceRecorder(clock=clock) if trace else None
        eng = clear_slots_on_install(JEngine(jcfg, params, JServe(**serve),
                                             clock=clock, trace=rec))
        if ladder:
            eng._ladder = [("staged", None), ("reference", _REF)]
    else:
        if res is not None:
            serve["resilience"] = TRes(**res)
        view = model.with_sparse(fused_decode=fused and not ladder)
        rec = tobs.TraceRecorder(clock=clock) if trace else None
        eng = TEngine(view.cfg, view, TServe(**serve), device="cpu", clock=clock,
                      trace=rec)
    box["eng"] = eng
    return eng


def _prompts_a():
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 256, 160)
    return [np.concatenate([shared, rng.integers(0, 256, 140)]),
            np.concatenate([shared, rng.integers(0, 256, 90)]),
            rng.integers(0, 256, 210), rng.integers(0, 256, 75)]


def _prompts_b():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, 300) for _ in range(3)]


def _prompts_c():
    """The first four of ``benchmarks/chaos_bench.py``'s prompts (150-300
    tokens, seed 0)."""
    rng = np.random.default_rng(0)
    rng.exponential(4.0, 6)
    return [rng.integers(0, 256, int(rng.integers(150, 300))) for _ in range(4)]


#: a storm that reaches every failure domain: ``default_storm()``'s faults,
#: a second device error that fails on both rungs (the ladder's floor:
#: retry and restore) and eight stuck ticks (the watchdog)
STORM = [dict(site="decode", tick=5, count=1),
         dict(site="decode_nan", from_tick=3, until_tick=60, every=7, count=3),
         dict(site="prefill", tick=2, count=1),
         dict(site="host_io", from_tick=6, until_tick=30, every=5, count=3),
         dict(site="promote_delay", from_tick=2, until_tick=40, every=4, count=4),
         dict(site="decode", tick=20, count=2),
         dict(site="tick_stuck", from_tick=30, until_tick=38)]

#: case -> (engine keywords, prompts, new tokens, fault plan, names the
#: trace must hold)
CASES = {
    "sparse-preempt": (
        dict(serve=dict(max_batch=2, max_context=512, prefill_chunk=128,
                        prefill_tokens_per_tick=192, pool_pages=28)),
        _prompts_a, 24, None,
        {"prefill.chunk", "prefix.match", "prefix.hit", "prefix.insert",
         "prefix.evict", "seq.preempt", "sparsity", "sched.admit"}),
    "tiered": (
        dict(serve=dict(max_batch=4, max_context=512, prefill_tokens_per_tick=512,
                        hbm_pages=28, host_pages=68)),
        _prompts_b, 24, None,
        {"seq.stall", "mem.demote", "mem.promote", "prefetch.miss",
         "prefetch.stage", "residency", "sparsity"}),
    "chaos": (
        dict(serve=dict(max_batch=3, max_context=512, prefill_chunk=128,
                        prefill_tokens_per_tick=512, hbm_pages=24, host_pages=50),
             res=dict(repromote_after=3), ladder=True),
        _prompts_c, 10, STORM,
        {"engine.degrade", "engine.repromote", "seq.retry", "seq.restore",
         "engine.watchdog", "mem.io_error", "mem.starvation_breaker",
         "prefetch.hit", "seq.stall", "resilience"}),
}


def _serve_traced(pkg, setup, case):
    kw, prompts, new_tokens, plan, _ = CASES[case]
    eng = _engine(pkg, setup, **kw)
    Req, res = (JRequest, jres) if pkg == "jax" else (TRequest, tres)
    if plan is not None:
        eng.set_fault_injector(res.FaultInjector([res.FaultSpec(**d) for d in plan],
                                                 seed=7))
    reqs = [Req(i, p.astype(np.int32), max_new_tokens=new_tokens)
            for i, p in enumerate(prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_ticks=2000)
    assert all(r.done for r in reqs)
    return eng.trace.to_chrome(), [list(r.output) for r in reqs], eng


@pytest.mark.parametrize("case", list(CASES))
def test_engine_trace_equals_jax(setup, case):
    """The same schedule gives the same events (times aside) and outputs;
    both validators accept both exports with every span of a traced run
    and the case's own events."""
    jtrace, jout, _ = _serve_traced("jax", setup, case)
    ttrace, tout, teng = _serve_traced("torch", setup, case)
    assert tout == jout
    events = _strip(ttrace)
    assert events == _strip(jtrace)
    assert ttrace["otherData"] == jtrace["otherData"]
    names = {e["name"] for e in events}
    assert CASES[case][4] <= names
    for trace in (ttrace, jtrace):
        for v in (tvalidate, jvalidate):
            assert v.validate_chrome_trace(
                trace, SPANS, ["pool", "queue", "sparsity"], ["sched.admit"]) == []
    json.dumps(ttrace)
    assert teng.pool.assert_consistent(known_pins=teng.prefix_cache.pages()) == []


# -- set_tracing on a live engine ---------------------------------------------------------


def _batch(Req, n, base_rid, new_tokens=6):
    rng = np.random.default_rng(3 + base_rid)
    return [Req(base_rid + i, rng.integers(0, 256, 96).astype(np.int32),
                max_new_tokens=new_tokens) for i in range(n)]


def _toggled(pkg, setup, toggle=True):
    """Four batches on one engine: untraced, traced, detached, traced again
    on the same recorder -> (export, outputs, recorder lengths, cache keys
    after each toggle)."""
    eng = _engine(pkg, setup, dict(max_batch=2, max_context=512), trace=False)
    o = jobs if pkg == "jax" else tobs
    Req = JRequest if pkg == "jax" else TRequest
    rec = o.TraceRecorder(clock=lambda: float(eng.metrics.ticks))
    outs, lens, keys = [], [], []
    for i, attach in enumerate((None, rec, None, rec)):
        if toggle:
            eng.set_tracing(attach)
        keys.append(sorted(k for k in eng.cache if k in ("_ptel", "_telemetry")))
        assert eng.trace is eng.metrics.trace
        assert (eng.trace is attach) if toggle else eng.trace is None
        reqs = _batch(Req, 2, 10 * i)
        for r in reqs:
            eng.submit(r)
        eng.run_until_done(max_ticks=300)
        outs.append([list(r.output) for r in reqs])
        lens.append(len(rec))
    return rec.to_chrome(), outs, lens, keys, eng


def test_set_tracing_toggles_live_engine_as_jax(setup):
    """As ``tests/test_obs.py``: off by default, telemetry planted with the
    recorder and taken out without it, a detached recorder frozen; then
    re-attached.  Events equal JAX's, tokens equal a never-traced
    engine's."""
    ttrace, touts, tlens, tkeys, teng = _toggled("torch", setup)
    jtrace, jouts, jlens, jkeys, _ = _toggled("jax", setup)
    _, plain, _, _, peng = _toggled("torch", setup, toggle=False)
    assert tkeys == jkeys == [[], ["_ptel", "_telemetry"], [], ["_ptel", "_telemetry"]]
    assert touts == jouts == plain
    assert tlens == jlens and tlens[0] == 0 < tlens[1] == tlens[2] < tlens[3]
    assert _strip(ttrace) == _strip(jtrace)
    assert tvalidate.validate_chrome_trace(ttrace, SPANS, ["sparsity"]) == []
    assert teng._tel_flush_recorder is not None and len(teng._tel_pending) == 0
    assert "sparsity_steps" not in peng.metrics.snapshot()
    assert teng.metrics.snapshot()["sparsity_steps"] > 0


def test_graphed_engine_keeps_one_capture_per_telemetry_variant(setup, stub_graphs):
    """Graphed (capture stubbed): the decode step is captured once with the
    counters and once without, in the engine's one pool; each toggle
    replays the variant already captured, with its tensors still planted,
    and the tokens equal the eager engine's."""
    from repro_torch.serving import step_graphs_disabled

    _, outs, _, _, eng = _toggled("torch", setup)
    with step_graphs_disabled():
        _, eager, _, _, e_eng = _toggled("torch", setup)
    assert outs == eager and not e_eng._graph_variants
    variants = eng._graph_variants
    assert set(variants) == {(0, False), (0, True)}
    assert all(g.replays > 0 for g in variants.values())
    assert variants[(0, True)]._tensors[1] is eng._tel_bufs["_telemetry"]
    assert variants[(0, False)]._tensors[1] is None
    assert set(eng._step_graphs) == {0} and eng._step_graphs[0] is variants[(0, True)]
    eng.set_tracing(None)
    assert eng._step_graphs[0] is variants[(0, False)]
