"""The port's async serving front-end (``repro_torch.serving.frontend``)
held to the properties of ``tests/test_frontend.py``, on the CPU.

A request streamed through :class:`AsyncFrontend` yields exactly the tokens
the synchronous ``run_until_done`` drain produces for the same requests:
under interleaved mid-flight arrivals, under preemption, for any arrival
ticks (a property test), and across a checkpoint restore (the pump's max
watermark neither re-emits nor reorders).  Submitting after ``shutdown``
raises, validation raises from ``submit``, ``drain`` keeps admission open,
and a request that exhausts its failure budget closes its stream as
failed.  Last, the port's streams equal the JAX front-end's for one arrival
schedule at temperature 0, on the same weights (``params_from_jax``).
These property tests run at the port's default temperature (0.6).
"""
import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - fallback: deterministic examples
    from _hypothesis_fallback import given, settings, strategies as st

from _jax_slot_reset import clear_slots_on_install
from repro.config import ServeConfig as JServe
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.models import Transformer as JTransformer
from repro.serving import AsyncFrontend as JFrontend
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch.config import ServeConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.models import Transformer
from repro_torch.resilience import FaultInjector, FaultSpec
from repro_torch.serving import AsyncFrontend, Engine, Request

_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU ops on one thread: the suite runs in parallel
    workers, and torch's default pool (a thread per core in every worker)
    oversubscribes the cores and slows these small ops several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    """Module-cached smoke model (a plain function, so the property test
    reaches it too)."""
    if "cfg" not in _CACHE:
        cfg = smoke_variant(get_config("llama3.2-3b"))
        _CACHE["cfg"] = cfg
        _CACHE["model"] = Transformer(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
    return _CACHE["cfg"], _CACHE["model"]


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _prompts(cfg, n, tokens=80, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, tokens).astype(np.int32)
            for _ in range(n)]


def _mkreq(i, prompts, new_tokens=6, Req=Request):
    return Req(i, prompts[i], max_new_tokens=new_tokens)


def _engine(model, injector=None, **serve_kw):
    eng = Engine(model.cfg, model, ServeConfig(**serve_kw), device="cpu")
    if injector is not None:
        eng.set_fault_injector(injector)
    return eng


def _sync_baseline(model, prompts, new_tokens=6, injector=None, **serve_kw):
    """Every request submitted up front, then ``run_until_done``."""
    eng = _engine(model, injector, **serve_kw)
    reqs = [_mkreq(i, prompts, new_tokens) for i in range(len(prompts))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_ticks=600)
    return {r.req_id: list(r.output) for r in reqs}


def _stream(eng, Frontend, arrivals, make):
    """Requests ``make(i)`` arrive at exact engine ticks (``arrivals``: tick
    -> ids; when the engine idles early the next group arrives at once)
    -> {id: streamed tokens}."""
    async def main():
        pending = {t: list(ids) for t, ids in arrivals.items()}
        streams = {}
        fe = Frontend(eng, max_ticks=600)
        task = asyncio.create_task(fe.run())
        while pending:
            t = min(pending)
            if fe.ticks >= t or not eng.scheduler.has_work:
                for i in pending.pop(t):
                    streams[i] = fe.submit(make(i))
            await asyncio.sleep(0)
        await fe.drain()
        fe.shutdown()
        await task
        return {i: await s.collect() for i, s in streams.items()}

    return asyncio.run(main())


def _async_run(model, prompts, arrivals, new_tokens=6, injector=None, **serve_kw):
    eng = _engine(model, injector, **serve_kw)
    return eng, _stream(eng, AsyncFrontend, arrivals,
                        lambda i: _mkreq(i, prompts, new_tokens))


def test_streamed_tokens_identical_under_interleaved_arrivals(setup):
    cfg, model = setup
    prompts = _prompts(cfg, 5)
    sync = _sync_baseline(model, prompts, max_batch=2, max_context=512)
    _, streamed = _async_run(model, prompts,
                             arrivals={0: [0], 2: [1, 2], 5: [3], 9: [4]},
                             max_batch=2, max_context=512)
    assert streamed == sync


def test_streamed_tokens_identical_under_preemption(setup):
    """A pool sized to force preemption mid-decode: streams stay
    token-identical and every request completes."""
    cfg, model = setup
    prompts = _prompts(cfg, 4, tokens=64, seed=1)
    kw = dict(max_batch=4, max_context=512, pool_pages=14)
    sync = _sync_baseline(model, prompts, new_tokens=12, **kw)
    eng, streamed = _async_run(model, prompts, new_tokens=12,
                               arrivals={0: [0, 1], 3: [2, 3]}, **kw)
    assert streamed == sync
    assert eng.metrics.preemptions > 0, "scenario must actually preempt"


@settings(max_examples=5, deadline=None)
@given(ticks=st.lists(st.integers(min_value=0, max_value=12),
                      min_size=3, max_size=3))
def test_streamed_tokens_identical_property(ticks):
    """Any arrival ticks give the sync baseline's tokens."""
    cfg, model = _setup()
    prompts = _prompts(cfg, 3, tokens=48, seed=2)
    if "prop_sync" not in _CACHE:
        _CACHE["prop_sync"] = _sync_baseline(model, prompts, new_tokens=4,
                                             max_batch=2, max_context=512)
    arrivals = {}
    for i, t in enumerate(ticks):
        arrivals.setdefault(t, []).append(i)
    _, streamed = _async_run(model, prompts, arrivals=arrivals, new_tokens=4,
                             max_batch=2, max_context=512)
    assert streamed == _CACHE["prop_sync"]


def test_restore_preserves_stream_ordering(setup):
    """An injected decode NaN forces a checkpoint restore mid-stream: the
    engine truncates ``req.output`` and regenerates it; the streamed tokens
    still equal the fault-free baseline exactly."""
    cfg, model = setup
    prompts = _prompts(cfg, 2, seed=3)
    kw = dict(max_batch=2, max_context=512)
    sync = _sync_baseline(model, prompts, new_tokens=10, **kw)
    inj = FaultInjector([FaultSpec("decode_nan", from_tick=2, until_tick=8,
                                   seq_id=0, count=1)])
    eng, streamed = _async_run(model, prompts, new_tokens=10,
                               arrivals={0: [0], 1: [1]}, injector=inj, **kw)
    assert inj.fired.get("decode_nan") == 1, "fault must actually fire"
    assert eng.metrics.checkpoints_restored >= 1
    assert streamed == sync


def test_submit_after_shutdown_raises(setup):
    cfg, model = setup
    fe = AsyncFrontend(_engine(model, max_batch=1, max_context=512))
    fe.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        fe.submit(_mkreq(0, _prompts(cfg, 1, tokens=48)))


def test_submit_validation_raises_synchronously(setup):
    """Engine-side validation (an oversize prompt, an unknown SLO class)
    surfaces from ``submit``, not from inside the serve loop."""
    _, model = setup
    fe = AsyncFrontend(_engine(model, max_batch=1, max_context=128))
    with pytest.raises(ValueError, match="exceeds max_context"):
        fe.submit(Request(0, np.zeros(120, np.int32), max_new_tokens=64))
    with pytest.raises(ValueError):
        fe.submit(Request(1, np.zeros(8, np.int32), max_new_tokens=2,
                          slo_class="urgent"))
    assert not fe._live


def test_drain_waits_without_closing_admission(setup):
    """``drain`` returns once in-flight work completes but keeps admission
    open; ``shutdown`` then ends ``run`` with the cumulative finished list."""
    cfg, model = setup
    prompts = _prompts(cfg, 2, tokens=48, seed=4)
    eng = _engine(model, max_batch=1, max_context=512)

    async def main():
        fe = AsyncFrontend(eng, max_ticks=400)
        s0 = fe.submit(_mkreq(0, prompts, new_tokens=4))
        task = asyncio.create_task(fe.run())
        await fe.drain()
        assert s0.req.done and not task.done()
        s1 = fe.submit(_mkreq(1, prompts, new_tokens=4))
        await fe.drain()
        assert s1.req.done
        fe.shutdown()
        finished = await task
        assert sorted(r.req_id for r in finished) == [0, 1]
        assert len(await s0.collect()) == 4
        assert len(await s1.collect()) == 4

    asyncio.run(main())


def test_stream_surfaces_failed_requests(setup):
    """A request that exhausts its failure budget closes its stream with
    status ``failed`` instead of hanging the consumer."""
    cfg, model = setup
    serve = ServeConfig(max_batch=1, max_context=512)
    serve = dataclasses.replace(serve, resilience=dataclasses.replace(
        serve.resilience, failure_budget=1))
    eng = Engine(cfg, model, serve, device="cpu")
    eng.set_fault_injector(FaultInjector([
        FaultSpec("decode_nan", from_tick=0, until_tick=10_000, seq_id=0)]))

    async def main():
        fe = AsyncFrontend(eng, max_ticks=400)
        stream = fe.submit(_mkreq(0, _prompts(cfg, 1, seed=5), new_tokens=8))
        task = asyncio.create_task(fe.run())
        fe.shutdown()
        await task
        return stream, await stream.collect()

    stream, toks = asyncio.run(main())
    assert stream.failed and stream.status == "failed"
    assert len(toks) < 8, "failure budget must cut the stream short"


def test_streams_equal_jax_frontend():
    """One arrival schedule at temperature 0 on the same weights: the
    port's front-end streams equal the JAX front-end's, and both equal the
    port's synchronous drain."""
    jcfg = j_smoke(j_get_config("llama3.2-3b"))
    tcfg = smoke_variant(get_config("llama3.2-3b"))
    params = JTransformer(jcfg).init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    prompts = _prompts(tcfg, 4, tokens=64, seed=6)
    kw = dict(max_batch=2, max_context=512, temperature=0.0)
    arrivals = {0: [0], 1: [1], 4: [2, 3]}
    jeng = clear_slots_on_install(JEngine(jcfg, params, JServe(**kw)))
    jout = _stream(jeng, JFrontend, arrivals,
                   lambda i: _mkreq(i, prompts, 6, Req=JRequest))
    _, tout = _async_run(model, prompts, arrivals, **kw)
    assert tout == jout
    assert tout == _sync_baseline(model, prompts, **kw)
    assert all(len(t) == 6 for t in tout.values())
