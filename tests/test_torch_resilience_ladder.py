"""The port's three-rung degradation ladder (fused -> staged -> reference
on the ``"cuda"`` backend, the kernels' plain versions on the CPU): driven
down and back up, a real fault kept on its rung, the probe's ``detach``, and
a degraded re-run's cache bytes against a clean run's."""
import numpy as np
import pytest
import torch

from repro_torch.serving import Request as TRequest

from test_torch_resilience import _engine, _ladder_engine, shared_weights


@pytest.fixture(scope="module")
def setup():
    return shared_weights()


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
