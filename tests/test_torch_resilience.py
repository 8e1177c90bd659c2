"""Failure domains of the port (``repro_torch.resilience`` and the engine's
degradation ladder, checkpoints and watchdog) against the JAX package's,
on the CPU: the shared setup, the injector, the hardened sampler, the
sparse-prefill gate, healthy rows and ``EngineStalled``.

The JAX engine and the port serve the smoke variant of llama3.2-3b with the
same weights (``params_from_jax``) under the same seeded fault plans at
temperature 0: outputs, statuses, failure records and every failure
counter of ``snapshot()`` must be equal.  The repair of the sparse-prefill
gate (the config decides, not the cache alone) is held to JAX's chunk.

The engine-level cases live in files of their own, so that no one file
holds most of the suite's time: the per-site plans of
``tests/test_resilience.py`` against JAX (``test_torch_resilience_sites.py``)
and at temperature 0.6 against the port's own fault-free run
(``test_torch_resilience_temperature.py``), the three-rung ladder
(``test_torch_resilience_ladder.py``) and the chaos twins
(``test_torch_resilience_chaos.py``).  Their helpers (``shared_weights``,
``_engine``, ``_run``, ``_record``, ``SITE_CASES``, ``_ladder_engine``) stay
here.
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


def shared_weights():
    """(JAX cfg, JAX params, port cfg, port model with the same weights)."""
    jcfg = j_smoke(j_get_config("llama3.2-3b"))
    tcfg = t_smoke(t_get_config("llama3.2-3b"))
    params = JTransformer(jcfg).init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def setup():
    """One JAX init shared by the file: ``shared_weights()``."""
    return shared_weights()


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
