"""The chaos twins: ``benchmarks/chaos_bench.py``'s traffic under
``default_storm()`` on the port's engine and on JAX's, on a flat page pool
and on the bench's tiered pool, where the host-tier sites fire."""
import numpy as np
import pytest

from repro import resilience as jres
from repro.serving import Request as JRequest

from repro_torch import resilience as tres
from repro_torch.serving import Request as TRequest

from test_torch_resilience import _engine, _record, shared_weights


@pytest.fixture(scope="module")
def setup():
    return shared_weights()


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
