"""Per-site recoveries of the port's engine against the JAX engine, on the
CPU: every plan of ``tests/test_resilience.py`` (``SITE_CASES``) at
temperature 0 (outputs, statuses, failure records, failure counters and
fired faults equal)."""
import pytest

from test_torch_resilience import _record, _run, SITE_CASES, shared_weights


@pytest.fixture(scope="module")
def setup():
    return shared_weights()


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
