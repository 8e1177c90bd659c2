"""Failure domains of the port (``repro_torch.resilience`` and the engine's
degradation ladder, checkpoints and watchdog) against the JAX package's,
on the CPU.

The JAX engine and the port serve the smoke variant of llama3.2-3b with the
same weights (``params_from_jax``) under the same seeded fault plans, one
per injection site (the plans of ``tests/test_resilience.py``), at
temperature 0: outputs, statuses, failure records and every failure
counter of ``snapshot()`` must be equal.  At temperature 0.6 the port is
held to its own fault-free run (token-identical).  The port's three-rung
ladder (fused -> staged -> reference on the ``"cuda"`` backend, the
kernels' plain versions here) is driven down and back up, and a degraded
re-run must leave the cache bytes a clean run on that rung leaves.  The
chaos twin serves ``benchmarks/chaos_bench.py``'s traffic under
``default_storm()`` on a flat page pool, and again on the bench's tiered
pool, where the host-tier sites fire.  The repair of the sparse-prefill
gate (the config decides, not the cache alone) is held to JAX's chunk.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _jax_slot_reset import clear_slots_on_install
from repro import resilience as jres
from repro.cache.paged_kv import PoolExhausted as JPoolExhausted
from repro.config import ServeConfig as JServe
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.models import Transformer as JTransformer
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch import resilience as tres
from repro_torch.cache.paged_kv import PoolExhausted
from repro_torch.config import ResilienceConfig
from repro_torch.config import ServeConfig as TServe
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import EngineStalled
from repro_torch.serving import Request as TRequest
from repro_torch.serving.sampler import SamplerAnomaly, guarded_sample

#: the failure counters ``snapshot()`` always carries
FAILURE_KEYS = ("retries", "replayed_tokens", "checkpoints_taken",
                "checkpoints_restored", "degradations", "degradations_by_rung",
                "repromotions", "watchdog_fires", "sampler_anomalies",
                "host_io_errors", "requests_failed", "failed_by_reason")
#: plus the fleet counters a fault moves
FLEET_KEYS = ("ticks", "decode_tokens", "prefill_tokens_computed",
              "prefix_hit_tokens", "preemptions", "requests_finished")
#: sparse prefill and an active plan at max_context 512 (the port's ladder)
SPARSE = dict(token_budget=128, block_sizes=((16, 32), (64, 16)),
              sparse_prefill=True, prefill_block_q=64)


@pytest.fixture(scope="module")
def setup():
    """One JAX init shared by the file: (JAX cfg, JAX params, port cfg,
    port model with the same weights)."""
    jcfg = j_smoke(j_get_config("llama3.2-3b"))
    tcfg = t_smoke(t_get_config("llama3.2-3b"))
    params = JTransformer(jcfg).init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


def _engine(pkg, cfg, weights, **serve_kw):
    serve_kw.setdefault("max_batch", 2)
    serve_kw.setdefault("max_context", 512)
    if pkg == "jax":
        return clear_slots_on_install(JEngine(cfg, weights, JServe(**serve_kw)))
    return TEngine(cfg, weights, TServe(**serve_kw), device="cpu")


def _run(pkg, cfg, weights, plan=None, n_requests=2, prompt_tokens=80,
         new_tokens=8, max_ticks=400, seed=0, tick_callback=None, keep=None,
         **serve_kw):
    """``tests/test_resilience.py``'s ``_run`` for either package: ``plan``
    is a list of FaultSpec dicts (None: no injector); the requests are
    appended to ``keep`` before the run."""
    eng = _engine(pkg, cfg, weights, **serve_kw)
    res, Req = (jres, JRequest) if pkg == "jax" else (tres, TRequest)
    inj = None
    if plan is not None:
        inj = res.FaultInjector([res.FaultSpec(**d) for d in plan], seed=seed)
        eng.set_fault_injector(inj)
    rng = np.random.default_rng(3)
    reqs = [Req(i, rng.integers(0, cfg.vocab_size, prompt_tokens).astype(np.int32),
                max_new_tokens=new_tokens)
            for i in range(n_requests)]
    for r in reqs:
        eng.submit(r)
    if keep is not None:
        keep.extend(reqs)
    eng.run_until_done(max_ticks=max_ticks, tick_callback=tick_callback)
    return eng, reqs, inj


def _record(eng, reqs):
    snap = eng.metrics.snapshot()
    return {
        "outputs": [list(r.output) for r in reqs],
        "status": [r.status for r in reqs],
        "done": [r.done for r in reqs],
        "failure": [r.failure for r in reqs],
        "counters": {k: snap[k] for k in FAILURE_KEYS + FLEET_KEYS},
    }


# -- the sparse-prefill gate (repair) -------------------------------------------


def test_dense_chunk_on_a_sparse_prefill_cache_matches_jax(setup):
    """A model whose config has ``sparse_prefill`` off runs a dense chunk on
    a cache built with it on (the ladder's reference rung does), and leaves
    the score segment untouched, as JAX's ``prefill_chunk`` does."""
    jcfg0, params, tcfg0, model0 = setup
    jcfg = dataclasses.replace(jcfg0, sparse=dataclasses.replace(
        jcfg0.sparse, backend="reference", **SPARSE))
    tcfg = dataclasses.replace(tcfg0, sparse=dataclasses.replace(
        tcfg0.sparse, backend="reference", **SPARSE))
    model = model0.with_sparse(**dataclasses.asdict(tcfg.sparse))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab_size, 384)
    C = 128
    chunks = [(off, np.asarray(tokens[off:off + C], np.int32)) for off in (0, 128, 256)]
    jsp, jdn = JTransformer(jcfg), JTransformer(dataclasses.replace(
        jcfg, sparse=dataclasses.replace(jcfg.sparse, sparse_prefill=False)))
    tdn = model.with_sparse(sparse_prefill=False)
    jc = jsp.init_cache(1, 512)
    tc = model.init_cache(1, 512)
    for off, buf in chunks[:2]:            # the sparse chunks fill the segment
        _, jc = jax.jit(jsp.prefill_chunk)(params, jc, np.int32(0), buf,
                                           np.int32(off), np.int32(C))
        model.prefill_chunk(tc, 0, buf.astype(np.int64), off, C)
    jseg = {n: np.array(jc["pos0"][n]) for n in ("pcodes", "pscale", "pzero")}
    tseg = [{n: e[n].clone() for n in ("pcodes", "pscale", "pzero")}
            for e in tc["layers"]]
    off, buf = chunks[2]
    jl, jc = jax.jit(jdn.prefill_chunk)(params, jc, np.int32(0), buf,
                                        np.int32(off), np.int32(C))
    tl, tc = tdn.prefill_chunk(tc, 0, buf.astype(np.int64), off, C)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for n, a in jseg.items():
        assert np.array_equal(np.array(jc["pos0"][n]), a)
    for e, seg in zip(tc["layers"], tseg):
        for n, t in seg.items():
            assert torch.equal(e[n], t), n


# -- the injector ----------------------------------------------------------------


def test_injector_fires_as_jax():
    """The counter-based rolls are the same in both packages: a grid of
    (site, tick, seq) opportunities with p < 1, windows, strides and counts
    fires identically, and the ``fired`` records and snapshots agree."""
    specs = [dict(site="decode", from_tick=0, until_tick=50, p=0.3),
             dict(site="host_io", from_tick=5, every=2, p=0.5, seq_id=1),
             dict(site="decode_nan", from_tick=2, until_tick=30, every=3, p=0.7,
                  count=5),
             dict(site="pool_alloc", tick=7, count=1),
             dict(site="tick_stuck", from_tick=4, until_tick=10, every=3)]

    def record(res, seed):
        inj = res.FaultInjector([res.FaultSpec(**d) for d in specs], seed=seed)
        out = [(t, site, sid, inj.fires(site, t, sid))
               for t in range(40) for site in res.SITES for sid in (None, 0, 1)
               for _ in range(2)]
        return out, inj.fired, inj.snapshot()

    for seed in (0, 7):
        assert record(tres, seed) == record(jres, seed)
    assert record(tres, 7)[0] != record(tres, 8)[0]
    sp = tres.FaultSpec("decode", from_tick=4, until_tick=10, every=3, count=2)
    inj = tres.FaultInjector([sp])
    assert [t for t in range(20) if inj.fires("decode", t)] == [4, 7]
    assert inj.snapshot()["fired"] == {"decode": 2}


def test_plans_round_trip_across_packages(tmp_path):
    storm = tres.default_storm()
    assert [dataclasses.asdict(s) for s in storm] == [
        dataclasses.asdict(s) for s in jres.default_storm()]
    storm[1].fired = 2                     # bookkeeping, not part of the plan
    jres.dump_plan(jres.default_storm(), str(tmp_path / "j.json"))
    tres.dump_plan(storm, str(tmp_path / "t.json"))
    from_j = tres.load_plan(str(tmp_path / "j.json"))
    from_t = jres.load_plan(str(tmp_path / "t.json"))
    assert [dataclasses.asdict(s) for s in from_j] == [
        dataclasses.asdict(s) for s in tres.default_storm()]
    assert [dataclasses.asdict(s) for s in from_t] == [
        dataclasses.asdict(s) for s in jres.default_storm()]
    inj = tres.FaultInjector.from_plan(str(tmp_path / "j.json"), seed=3)
    assert inj.seed == 3 and len(inj.specs) == len(storm)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"site": "decode"}))
    with pytest.raises(ValueError, match="JSON list"):
        tres.load_plan(str(bad))
    with pytest.raises(ValueError, match="unknown fault site"):
        tres.FaultSpec("gamma_ray")
    with pytest.raises(ValueError, match="every must be"):
        tres.FaultSpec("decode", every=0)


def test_fault_types():
    """``HostIOError`` is absorbed by every ``PoolExhausted`` catch site and
    skips prefix-cache eviction; the ladder catches injected device errors
    and ``FloatingPointError`` only (no CUDA error type, unlike JAX's
    runtime error)."""
    assert issubclass(tres.HostIOError, PoolExhausted)
    assert not issubclass(tres.HostIOError, JPoolExhausted)
    assert tres.HostIOError.tier_bound is True
    assert issubclass(tres.InjectedDeviceError, tres.InjectedFault)
    assert issubclass(tres.InjectedFault, RuntimeError)
    assert tres.DEVICE_FAULTS == (tres.InjectedDeviceError, FloatingPointError)
    assert set(tres.SITES) == set(jres.SITES)
    inj = tres.FaultInjector([tres.FaultSpec("pool_alloc", tick=1),
                              tres.FaultSpec("host_io", tick=1),
                              tres.FaultSpec("prefill", tick=1)])
    for site, exc in (("pool_alloc", PoolExhausted), ("host_io", tres.HostIOError),
                      ("prefill", tres.InjectedDeviceError)):
        inj.check_raise(site, tick=0)                   # not active: no raise
        with pytest.raises(exc, match=f"injected {site} fault at tick 1"):
            inj.check_raise(site, tick=1, seq_id=4)


# -- the hardened sampler --------------------------------------------------------


def test_guarded_sample_raises_on_poisoned_rows():
    logits = torch.zeros((3, 8))
    logits[1, 3] = float("nan")
    with pytest.raises(SamplerAnomaly) as ei:
        guarded_sample(logits, [10, 11, 12], [0, 0, 0])
    assert ei.value.seq_ids == [11]
    clean = guarded_sample(torch.zeros((3, 8)), [10, 11, 12], [0, 0, 0])
    assert clean.shape == (3,)
    logits[1, 3] = float("inf")
    with pytest.raises(SamplerAnomaly):
        guarded_sample(logits, [10, 11, 12], [0, 0, 0], temperature=0.0)


def test_nan_row_at_temperature_surfaces_as_anomaly(setup):
    """``torch.multinomial`` raises ``RuntimeError`` on a NaN row: the
    engine samples only the finite rows, so a poisoned row at temperature
    0.6 is a ``SamplerAnomaly`` (restore, then FAILED), never a
    ``RuntimeError`` out of the tick."""
    _, _, tcfg, model = setup
    eng = _engine("torch", tcfg, model, temperature=0.6)
    lg = torch.randn((2, tcfg.vocab_size))
    lg[0, 5] = float("nan")
    toks, fin = eng._sample([3, 4], [0, 0], lg)
    assert fin.tolist() == [False, True] and toks[0] == 0
    eng, reqs, _ = _run("torch", tcfg, model, temperature=0.6, new_tokens=6,
                        plan=[dict(site="decode_nan", from_tick=0,
                                   until_tick=10_000, seq_id=0)])
    assert reqs[0].status == "failed" and reqs[1].status == "ok"
    assert reqs[0].failure["reason"] == "sampler_anomaly"


# -- per-site recoveries, port against JAX -----------------------------------------

#: name -> (plan, _run keywords): the plans of tests/test_resilience.py
SITE_CASES = {
    "empty": ([], {}),
    "decode_nan": ([dict(site="decode_nan", from_tick=2, until_tick=6, seq_id=0,
                         count=1)], {"new_tokens": 10}),
    "decode": ([dict(site="decode", tick=3, count=1)], {}),
    "prefill": ([dict(site="prefill", tick=0, count=1)], {"new_tokens": 6}),
    "pool_alloc": ([dict(site="pool_alloc", from_tick=0, until_tick=30, every=2,
                         count=3)],
                   {"n_requests": 3, "prompt_tokens": 96, "max_batch": 3}),
    "failure_budget": ([dict(site="decode_nan", from_tick=0, until_tick=10_000,
                             seq_id=0)], {"new_tokens": 6}),
    "tick_stuck": ([dict(site="tick_stuck", from_tick=2, until_tick=14)], {}),
}


@pytest.mark.parametrize("case", list(SITE_CASES))
def test_site_recovers_as_jax(setup, case):
    """At temperature 0 the port's outputs, statuses, failure records and
    failure counters equal JAX's, the injectors fire the same faults, and
    every request that ends ``ok`` equals the fault-free run."""
    jcfg, params, tcfg, model = setup
    plan, kw = SITE_CASES[case]
    kw = dict(kw, temperature=0.0)
    je, jr, jinj = _run("jax", jcfg, params, plan=plan, **kw)
    te, tr, tinj = _run("torch", tcfg, model, plan=plan, **kw)
    _, base, _ = _run("torch", tcfg, model, **kw)
    assert _record(te, tr) == _record(je, jr)
    assert tinj.snapshot() == jinj.snapshot()
    assert all(r.done for r in tr)
    for r, b in zip(tr, base):
        if r.status == "ok":
            assert r.output == b.output
    assert te.pool.assert_consistent(known_pins=te.prefix_cache.pages()) == []
    snap = te.metrics.snapshot()
    if case == "empty":
        assert snap["retries"] == 0 and te.pool.fault_hook is not None
        te.set_fault_injector(None)
        assert te.pool.fault_hook is None
    elif case != "pool_alloc":
        assert sum(tinj.fired.values()) >= 1
    if case == "failure_budget":
        assert tr[0].failure["retries"] > te.resilience.failure_budget
        assert te.metrics.requests[0].t_finish is None
    if case == "tick_stuck":
        assert tinj.fired["tick_stuck"] >= te.resilience.watchdog_ticks
        assert snap["watchdog_fires"] >= 1


@pytest.mark.parametrize("case", list(SITE_CASES))
def test_site_recovers_token_identical_at_temperature(setup, case):
    """At temperature 0.6 (JAX's draws differ from the port's) the port
    is held to its own fault-free run: every ``ok`` request equal, the
    budget case's poisoned request FAILED."""
    _, _, tcfg, model = setup
    plan, kw = SITE_CASES[case]
    kw = dict(kw, temperature=0.6)
    te, tr, _ = _run("torch", tcfg, model, plan=plan, **kw)
    _, base, _ = _run("torch", tcfg, model, **kw)
    assert all(r.done for r in tr)
    assert [r.status == "ok" for r in tr] == [
        not (case == "failure_budget" and r.req_id == 0) for r in tr]
    for r, b in zip(tr, base):
        if r.status == "ok":
            assert r.output == b.output
    assert te.pool.assert_consistent(known_pins=te.prefix_cache.pages()) == []


def test_healthy_rows_commit_as_jax(setup):
    """A batch of two with one poisoned row: the healthy row commits in
    the same tick, the poisoned one restores; output lengths match JAX's
    tick by tick."""
    jcfg, params, tcfg, model = setup
    plan = [dict(site="decode_nan", tick=3, seq_id=0, count=1)]
    lens = {"jax": [], "torch": []}
    outs = {}
    for pkg, cfg, w in (("jax", jcfg, params), ("torch", tcfg, model)):
        reqs = []

        def cb(eng, tick, pkg=pkg, reqs=reqs):
            lens[pkg].append(tuple(len(r.output) for r in reqs))

        eng, _, _ = _run(pkg, cfg, w, plan=plan, temperature=0.0,
                         tick_callback=cb, keep=reqs)
        outs[pkg] = _record(eng, reqs)
    assert lens["torch"] == lens["jax"]
    assert outs["torch"] == outs["jax"]
    assert outs["torch"]["counters"]["checkpoints_restored"] == 1
    # in the poisoned tick the healthy row advanced, the poisoned one fell back
    t = 3
    assert lens["torch"][t][1] == lens["torch"][t - 1][1] + 1
    assert lens["torch"][t][0] < lens["torch"][t - 1][0] + 1


def test_engine_stalled_carries_diagnostics_as_jax(setup):
    jcfg, params, tcfg, model = setup
    diags = {}
    for pkg, cfg, w in (("jax", jcfg, params), ("torch", tcfg, model)):
        eng = _engine(pkg, cfg, w, max_batch=1)
        Req = JRequest if pkg == "jax" else TRequest
        rng = np.random.default_rng(5)
        for i in range(2):
            eng.submit(Req(i, rng.integers(0, cfg.vocab_size, 80).astype(np.int32),
                           max_new_tokens=50))
        with pytest.raises(Exception) as ei:
            eng.run_until_done(max_ticks=3)
        assert type(ei.value).__name__ == "EngineStalled"
        assert ei.value.retired == []
        diags[pkg] = ei.value.diagnostics
    assert isinstance(ei.value, EngineStalled)
    d, jd = diags["torch"], diags["jax"]
    assert d["tick"] == 3 and d["waiting"] + d["running"] >= 1
    last, jlast = d.pop("last_snapshot"), jd.pop("last_snapshot")
    assert d == jd
    assert set(last) == set(jlast)
    assert {k: last[k] for k in FAILURE_KEYS + FLEET_KEYS} == {
        k: jlast[k] for k in FAILURE_KEYS + FLEET_KEYS}
    healthy = _engine("torch", tcfg, model, max_batch=1)
    assert healthy.diagnostics()["running"] == 0
    assert healthy.diagnostics()["rung"] == "reference"


# -- the three-rung ladder ----------------------------------------------------------


def _ladder_engine(tcfg0, model0, plan=None, tick_callback=None, attach=None,
                   **res_kw):
    """The ``"cuda"`` backend with the fused decode and sparse prefill (the
    plain versions of the kernels on the CPU), two requests; ``attach(eng)``
    runs before the engine does."""
    tcfg = dataclasses.replace(tcfg0, sparse=dataclasses.replace(
        tcfg0.sparse, backend="cuda", fused_decode=True, **SPARSE))
    model = model0.with_sparse(**dataclasses.asdict(tcfg.sparse))
    eng = TEngine(tcfg, model, TServe(
        max_batch=2, max_context=512, prefill_chunk=128,
        prefill_tokens_per_tick=192, temperature=0.0,
        resilience=ResilienceConfig(**res_kw)), device="cpu")
    if plan is not None:
        eng.set_fault_injector(tres.FaultInjector([tres.FaultSpec(**d) for d in plan]))
    if attach is not None:
        attach(eng)
    rng = np.random.default_rng(9)
    reqs = [TRequest(i, rng.integers(0, tcfg.vocab_size, n).astype(np.int32),
                     max_new_tokens=16) for i, n in enumerate((200, 150))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_ticks=200, tick_callback=tick_callback)
    return eng, reqs


def test_ladder_degrades_and_repromotes(setup):
    """Fused -> staged on a prefill fault at rung 0, staged -> reference on
    a decode fault, a NaN row on the staged rung back to reference, and
    ``repromote_after`` clean decode ticks at a time back to fused; no
    request is charged a retry and the tokens equal the fault-free run's.
    The rung views share the engine model's parameter tensors."""
    _, _, tcfg, model = setup
    _, base = _ladder_engine(tcfg, model, repromote_after=3)
    rungs = []
    plan = [dict(site="prefill", tick=0, count=1),
            dict(site="decode", tick=2, count=1),
            dict(site="decode_nan", tick=7, seq_id=1, count=1)]
    eng, reqs = _ladder_engine(tcfg, model, plan=plan, repromote_after=3,
                               tick_callback=lambda e, t: rungs.append(e._rung))
    assert [name for name, _ in eng._ladder] == ["fused", "staged", "reference"]
    assert eng._fault.fired == {"prefill": 1, "decode": 1, "decode_nan": 1}
    snap = eng.metrics.snapshot()
    assert snap["degradations_by_rung"] == {"staged": 1, "reference": 2}
    assert snap["repromotions"] == 3 and eng._rung == 0
    assert snap["retries"] == 0 and snap["checkpoints_restored"] == 0
    assert {0, 1, 2} <= set(rungs)
    assert all(r.status == "ok" for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in base]
    assert eng.pool.assert_consistent(known_pins=eng.prefix_cache.pages()) == []
    views = eng._rung_models
    assert set(views) == {0, 1, 2}
    assert [v.cfg.sparse.backend for v in views.values()] == ["cuda", "cuda",
                                                               "reference"]
    assert [v.cfg.sparse.fused_decode for v in views.values()] == [True, False,
                                                                   False]
    for v in views.values():
        for p, q in zip(v.parameters(), eng.model.parameters()):
            assert p.data_ptr() == q.data_ptr()


@pytest.mark.parametrize("fault", ["nan_row", "floating_point_error"])
def test_real_fault_stays_on_its_rung(setup, fault):
    """No hidden fallback: a fault the injector did not cause (here a NaN
    row out of rung 0's decode step, or a ``FloatingPointError`` raised by
    it) never moves the ladder.  It is charged to the implicated sequences'
    failure budgets on rung 0 (the NaN row's sequence alone, every decoding
    sequence for the error), the healthy row commits, no rung view is
    built and every step of the run ran on rung 0.  The tokens committed
    before the fault, and all of the healthy row's, equal the fault-free
    run's (a restored sequence re-prefills its tokens through sparse
    prefill, so what it samples after the fault may differ)."""
    from repro_torch.serving.probe import LadderProbe

    _, _, tcfg, model = setup
    _, base = _ladder_engine(tcfg, model)
    t_bad, probes, before = 6, [], {}

    def attach(eng):
        inner = eng._rung_step_fns

        def fns(rung):
            decode, chunk = inner(rung)

            def bad_decode(cache, tokens):
                if eng.metrics.ticks != t_bad:
                    return decode(cache, tokens)
                if fault == "floating_point_error":
                    raise FloatingPointError("overflow in the decode step")
                logits, cache = decode(cache, tokens)
                slot = next(s.slot for s in eng.slots if s is not None and s.seq_id == 0)
                logits[slot] = float("nan")
                return logits, cache
            return bad_decode, chunk

        eng._rung_step_fns = fns
        probes.append(LadderProbe(eng))

    def callback(eng, tick):
        probes[0](eng, tick)
        if tick == t_bad - 1:
            before.update((s.req.req_id, list(s.req.output))
                          for s in eng.scheduler.running.values())

    eng, reqs = _ladder_engine(tcfg, model, attach=attach, tick_callback=callback)
    snap = eng.metrics.snapshot()
    retried = 1 if fault == "nan_row" else 2
    assert snap["degradations"] == 0 and snap["repromotions"] == 0
    assert eng._rung == 0 and set(eng._rung_models) == {0}
    assert {r for st in probes[0].steps.values() for r, _, _ in st} == {0}
    assert snap["retries"] == snap["checkpoints_restored"] == retried
    assert snap["sampler_anomalies"] == (1 if fault == "nan_row" else 0)
    assert all(r.status == "ok" and len(r.output) == 16 for r in reqs)
    assert sorted(before) == [0, 1] and all(
        all(before[r.req_id] == x.output[:len(before[r.req_id])] for x in (r, q))
        for r, q in zip(reqs, base))
    if fault == "nan_row":
        assert reqs[1].output == base[1].output
    assert eng.pool.assert_consistent(known_pins=eng.prefix_cache.pages()) == []


def test_probe_detach_releases_the_engine(setup):
    """``LadderProbe`` and ``SampleRecorder`` record a run's steps by tick
    and its sampled rows; ``detach`` restores the engine's own methods and
    drops the records' last reference to it, so a kept record does not
    keep an engine (and its cache) alive."""
    import gc
    import weakref

    from repro_torch.serving.probe import LadderProbe, SampleRecorder

    _, _, tcfg, model = setup
    eng = _engine("torch", tcfg, model)
    probe, samples = LadderProbe(eng), SampleRecorder(eng)
    eng.submit(TRequest(0, np.arange(80, dtype=np.int32), max_new_tokens=3))
    eng.run_until_done(max_ticks=50, tick_callback=probe)
    probe.detach()
    samples.detach()
    assert "_rung_step_fns" not in vars(eng) and "_sample" not in vars(eng)
    assert [k for st in probe.steps.values() for _, k, _ in st].count("decode") == 2
    assert sorted(samples.tokens) == [(0, 0), (0, 1), (0, 2)]
    assert probe.whole_decode_ticks() == {0: sorted(
        t for t, st in probe.steps.items() if st[-1][1] == "decode")}
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None


def test_degraded_rerun_leaves_a_clean_runs_bytes(setup):
    """A NaN row is found after the fused step ran and advanced the cache in
    place; its staged re-run must leave the bytes a run that went to the
    staged rung before any step ran leaves (a decode fault raises before
    the step)."""
    _, _, tcfg, model = setup
    t = 4
    snaps = {}

    def grab(name):
        def cb(eng, tick):
            if tick == t:
                snaps[name] = {"seq_len": eng.cache["seq_len"].clone(), "layers": [
                    {k: v.clone() for k, v in e.items()} for e in eng.cache["layers"]]}
        return cb

    runs = {}
    for name, site, kw in (("nan", "decode_nan", {"seq_id": 0}), ("fault", "decode", {})):
        runs[name] = _ladder_engine(tcfg, model, tick_callback=grab(name),
                                    plan=[dict(site=site, tick=t, count=1, **kw)])
    for name, (eng, _) in runs.items():
        assert eng.metrics.snapshot()["degradations_by_rung"] == {"staged": 1}
    a, b = snaps["nan"], snaps["fault"]
    assert torch.equal(a["seq_len"], b["seq_len"])
    for ea, eb in zip(a["layers"], b["layers"]):
        assert ea.keys() == eb.keys()
        for k in ea:
            assert torch.equal(ea[k], eb[k]), k
    assert ([r.output for r in runs["nan"][1]] == [r.output for r in runs["fault"][1]])


# -- the chaos twin -------------------------------------------------------------------


def _chaos_traffic(vocab, Req, n_requests=6, new_tokens=12, seed=0):
    """``benchmarks/chaos_bench.py``'s ``_make_traffic``."""
    rng = np.random.default_rng(seed)
    arrivals = np.floor(np.cumsum(rng.exponential(4.0, n_requests))).astype(int)
    prompts = [rng.integers(0, vocab, int(rng.integers(150, 300))).astype(np.int32)
               for _ in range(n_requests)]
    return ([Req(i, prompts[i].copy(), max_new_tokens=new_tokens)
             for i in range(n_requests)], list(arrivals))


def _chaos_drive(eng, reqs, arrivals, max_ticks=3000):
    """``chaos_bench._drive``: submit by the arrival schedule, run to drain
    -> TTFT in ticks."""
    order = sorted(range(len(reqs)), key=lambda i: arrivals[i])
    submit_tick, first_tick = {}, {}
    i = tick = 0
    while i < len(order) or eng.scheduler.has_work:
        while i < len(order) and arrivals[order[i]] <= tick:
            eng.submit(reqs[order[i]])
            submit_tick[order[i]] = tick
            i += 1
        eng.step()
        tick += 1
        for r in reqs:
            if r.req_id not in first_tick and r.output:
                first_tick[r.req_id] = tick
        assert tick <= max_ticks
    return [first_tick[r] - submit_tick[r] for r in first_tick]


def test_chaos_twin_matches_jax(setup):
    """``chaos_bench``'s traffic (6 requests of 150-300 tokens, chunks of
    128, max_context 512, max_batch 3) under ``default_storm()`` seed 7 on a
    flat pool of the bench's 100 pages: nothing lost, every ``ok`` request
    equal to the fault-free run, the pool clean, p99 TTFT in ticks within
    the bench's bound (8 x baseline + 40); the JAX engine on the same
    traffic and plan gives the same outputs and counters."""
    jcfg, params, tcfg, model = setup
    serve = dict(max_batch=3, max_context=512, prefill_chunk=128,
                 prefill_tokens_per_tick=512, pool_pages=100, temperature=0.0)
    out, ttft = {}, {}
    for pkg, cfg, w, res, Req in (("jax", jcfg, params, jres, JRequest),
                                  ("torch", tcfg, model, tres, TRequest),
                                  ("base", tcfg, model, None, TRequest)):
        eng = _engine("jax" if pkg == "jax" else "torch", cfg, w, **serve)
        if res is not None:
            eng.set_fault_injector(res.FaultInjector(res.default_storm(), seed=7))
        reqs, arrivals = _chaos_traffic(cfg.vocab_size, Req)
        ttft[pkg] = _chaos_drive(eng, reqs, arrivals)
        out[pkg] = _record(eng, reqs)
        assert all(r.done for r in reqs)
        assert eng.pool.assert_consistent(known_pins=eng.prefix_cache.pages()) == []
        if pkg == "torch":
            fired = eng._fault.fired
    assert out["torch"] == out["jax"]
    assert ttft["torch"] == ttft["jax"]
    for o, b, st in zip(out["torch"]["outputs"], out["base"]["outputs"],
                        out["torch"]["status"]):
        if st == "ok":
            assert o == b
    assert fired.get("host_io", 0) == 0 and fired.get("promote_delay", 0) == 0
    assert sum(fired.values()) >= 5
    p99_base = float(np.percentile(ttft["base"], 99))
    assert float(np.percentile(ttft["torch"], 99)) <= 8.0 * p99_base + 40.0


#: the tiering counters of ``snapshot()`` that depend on no clock
TIER_KEYS = ("hbm_resident_pages", "host_resident_pages", "prefetch_hits",
             "prefetch_misses", "prefetch_staged", "migrations", "migration_bytes",
             "stalls")


def test_tiered_chaos_twin_matches_jax(setup):
    """``chaos_bench``'s traffic and storm (``default_storm()`` seed 7) on
    the bench's tiered pool of 30 HBM + 70 host pages: nothing lost, every
    ``ok`` request equal to the fault-free tiered run, the pool clean; the
    JAX engine on the same traffic and plan gives the same outputs,
    statuses, counters (tiering ones included), fired faults and TTFT in
    ticks, and the tiered-memory sites fire (``host_io`` at least once,
    ``promote_delay`` too)."""
    jcfg, params, tcfg, model = setup
    serve = dict(max_batch=3, max_context=512, prefill_chunk=128,
                 prefill_tokens_per_tick=512, hbm_pages=30, host_pages=70,
                 temperature=0.0)
    out, ttft, fired, tiers = {}, {}, {}, {}
    for pkg, cfg, w, res, Req in (("jax", jcfg, params, jres, JRequest),
                                  ("torch", tcfg, model, tres, TRequest),
                                  ("base", tcfg, model, None, TRequest)):
        eng = _engine("jax" if pkg == "jax" else "torch", cfg, w, **serve)
        if res is not None:
            eng.set_fault_injector(res.FaultInjector(res.default_storm(), seed=7))
        reqs, arrivals = _chaos_traffic(cfg.vocab_size, Req)
        ttft[pkg] = _chaos_drive(eng, reqs, arrivals)
        out[pkg] = _record(eng, reqs)
        snap = eng.metrics.snapshot()
        tiers[pkg] = {k: snap[k] for k in TIER_KEYS}
        assert all(r.done for r in reqs)
        assert eng.pool.assert_consistent(known_pins=eng.prefix_cache.pages()) == []
        if res is not None:
            fired[pkg] = eng._fault.fired
    assert out["torch"] == out["jax"]
    assert ttft["torch"] == ttft["jax"]
    assert tiers["torch"] == tiers["jax"]
    assert fired["torch"] == fired["jax"]
    assert fired["torch"].get("host_io", 0) >= 1
    assert fired["torch"].get("promote_delay", 0) >= 1
    assert tiers["torch"]["migration_bytes"] > 0
    for o, b, st in zip(out["torch"]["outputs"], out["base"]["outputs"],
                        out["torch"]["status"]):
        if st == "ok":
            assert o == b
