"""Per-site recoveries of the port's engine at temperature 0.6, on the
CPU: every plan of ``tests/test_resilience.py`` (``SITE_CASES``) held to the
port's own fault-free run (JAX's draws differ from the port's)."""
import pytest

from test_torch_resilience import _run, SITE_CASES, shared_weights


@pytest.fixture(scope="module")
def setup():
    return shared_weights()


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
