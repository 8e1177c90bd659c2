"""Tiered KV memory of the port (``repro_torch.memory`` and the engine's
tiered path) against the JAX package's (``repro.memory``), on the CPU.

- Every pool test of ``tests/test_memory.py`` runs as one op sequence on
  both packages' pools: the return values (or exceptions), the migration
  callbacks and the whole pool state (free list, refcounts, tables, pins,
  tiers, owners, shield, stats) are compared after every op.
- The random workload of ``tests/test_memory.py`` runs in lock-step on both
  pools as a differential.
- Engines serve the smoke variant of llama3.2-3b with the same weights
  (``params_from_jax``) at temperature 0, under a clock that reads the
  tick counter (so stall times and TTFT compare exactly): overcommitted
  (tokens identical to the flat pool's and to the JAX engine's, every
  snapshot key equal to JAX's, ``migration_bytes`` included), the forced
  miss and the starvation breaker of ``tests/test_memory.py``, and the two
  construction errors.
- ``selected_page_masks`` against JAX's on scores with ties, for margins
  of 0, 2 and past the number of blocks.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - fallback: deterministic examples
    from _hypothesis_fallback import given, settings, strategies as st

from _jax_slot_reset import clear_slots_on_install
from repro import memory as jmem
from repro import resilience as jres
from repro.cache import paged_kv as jkv
from repro.config import ServeConfig as JServe
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke
from repro.core.ragged import layout_for as j_layout_for
from repro.core.selection import selected_page_masks as j_masks
from repro.models import Transformer as JTransformer
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest

from repro_torch import memory as tmem
from repro_torch import resilience as tres
from repro_torch.cache import paged_kv as tkv
from repro_torch.config import ServeConfig as TServe
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core.ragged import layout_for as t_layout_for
from repro_torch.core.selection import selected_page_masks as t_masks
from repro_torch.core.stacked import as_arrays
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving.probe import demote_around_shield
from repro_torch.serving.scheduler import DECODE

PKGS = {
    "jax": SimpleNamespace(PagePool=jkv.PagePool, PoolExhausted=jkv.PoolExhausted,
                           mem=jmem),
    "torch": SimpleNamespace(PagePool=tkv.PagePool, PoolExhausted=tkv.PoolExhausted,
                             mem=tmem),
}


# -- the pools, op by op ---------------------------------------------------------


def _state(pool):
    st_ = {"free": list(pool._free), "rc": list(pool._refcount),
           "tables": {s: list(t.physical) for s, t in pool._tables.items()},
           "tokens": dict(pool._tokens), "pins": sorted(pool._cache_pins),
           "peak": pool.peak_used_pages}
    if hasattr(pool, "_tier"):
        st_.update(tiers=list(pool._tier), stats=pool.stats(),
                   owners={p: dict(o) for p, o in pool._owners.items()},
                   last_used=dict(pool._last_used),
                   shield=sorted(pool._protected), auto=sorted(pool._auto_protected))
    return st_


def _value(v):
    if isinstance(v, (jkv.PageTable, tkv.PageTable)):
        return ("table", v.seq_id, list(v.physical))
    return v


class Recorder:
    """Runs ops on one pool and records, after each, the op's value (or
    exception) and the pool's whole state; the pool's migration callbacks
    append to the same record."""

    def __init__(self, P):
        self.P, self.log = P, []

    def op(self, label, fn, pool):
        try:
            out = _value(fn())
        except self.P.PoolExhausted as exc:
            out = ("PoolExhausted", getattr(exc, "tier_bound", False))
        except AssertionError:
            out = "AssertionError"
        self.log.append((label, out, _state(pool)))
        return out

    def callbacks(self, pool):
        pool.set_callbacks(
            lambda p, own: self.log.append(("demote", p, list(own),
                                            pool.is_protected(p))),
            lambda p, own, fr: self.log.append(("promote", p, list(own), fr)),
            lambda p: self.log.append(("drop_host", p)),
        )


def scenario_leak_candidates(P, r):
    pool = P.PagePool(8)
    t = r.op("allocate", lambda: pool.allocate(1, 32), pool)
    p0 = t[2][0]
    r.op("pin", lambda: pool.cache_ref(p0), pool)
    r.op("free", lambda: pool.free(1), pool)
    r.op("audit known", lambda: pool.assert_consistent(known_pins=[p0]), pool)
    r.op("audit unknown", lambda: pool.assert_consistent(known_pins=[]), pool)


def scenario_phantom_known_pin(P, r):
    pool = P.PagePool(4)
    r.op("allocate", lambda: pool.allocate(1, 16), pool)
    r.op("audit phantom", lambda: pool.assert_consistent(known_pins=[3]), pool)


def scenario_peak_used_pages(P, r):
    pool = P.PagePool(16)
    r.op("allocate", lambda: pool.allocate(1, 16 * 10), pool)
    r.op("free", lambda: pool.free(1), pool)
    r.op("allocate", lambda: pool.allocate(2, 16 * 3), pool)


def scenario_take_demotes_coldest(P, r):
    pool = P.mem.TieredPagePool(hbm_pages=4, host_pages=4, page_size=16)
    t1 = r.op("allocate", lambda: pool.allocate(1, 16 * 4), pool)
    r.op("unshield", lambda: pool.set_protected([]), pool)
    r.op("tick", pool.tick, pool)
    r.op("touch", lambda: pool.touch(t1[2][2:]), pool)
    r.callbacks(pool)
    r.op("allocate", lambda: pool.allocate(2, 16 * 2), pool)
    r.op("audit", pool.assert_consistent, pool)


def scenario_protected_block_demotion(P, r):
    pool = P.mem.TieredPagePool(hbm_pages=2, host_pages=4)
    t = r.op("allocate", lambda: pool.allocate(1, 16 * 2), pool)
    r.op("shield all", lambda: pool.set_protected(t[2]), pool)
    r.op("allocate", lambda: pool.allocate(2, 16), pool)
    r.op("unshield", lambda: pool.set_protected([]), pool)
    r.op("allocate", lambda: pool.allocate(2, 16), pool)
    r.op("audit", pool.assert_consistent, pool)


def scenario_host_capacity(P, r):
    pool = P.mem.TieredPagePool(hbm_pages=2, host_pages=1)
    r.op("allocate", lambda: pool.allocate(1, 16 * 2), pool)
    r.op("unshield", lambda: pool.set_protected([]), pool)
    r.op("allocate", lambda: pool.allocate(2, 16), pool)
    r.op("allocate", lambda: pool.allocate(3, 16), pool)
    r.op("audit", pool.assert_consistent, pool)


def scenario_snapshot_forks_back(P, r):
    pool = P.mem.TieredPagePool(hbm_pages=2, host_pages=2)
    t = r.op("allocate", lambda: pool.allocate(1, 16 * 2), pool)
    for p in t[2]:
        r.op("pin", lambda: pool.cache_ref(p), pool)
    r.op("free", lambda: pool.free(1), pool)
    r.op("fork", lambda: pool.fork(2, t[2], 16 * 2), pool)
    r.op("audit", pool.assert_consistent, pool)


def scenario_pinned_stay_demotable(P, r):
    pool = P.mem.TieredPagePool(hbm_pages=2, host_pages=2)
    t = r.op("allocate", lambda: pool.allocate(1, 16 * 2), pool)
    for p in t[2]:
        r.op("pin", lambda: pool.cache_ref(p), pool)
    r.op("unshield", lambda: pool.set_protected([]), pool)
    r.op("allocate", lambda: pool.allocate(2, 16), pool)
    r.op("audit", pool.assert_consistent, pool)


def scenario_cow_promotes_first(P, r):
    pool = P.mem.TieredPagePool(hbm_pages=2, host_pages=2)
    t1 = r.op("allocate", lambda: pool.allocate(1, 16), pool)
    r.op("fork", lambda: pool.fork(2, t1[2], 16), pool)
    r.op("unshield", lambda: pool.set_protected([]), pool)
    r.op("allocate", lambda: pool.allocate(3, 16 * 2), pool)
    r.op("unshield", lambda: pool.set_protected([]), pool)
    r.callbacks(pool)
    r.op("cow", lambda: pool.ensure_owned(2, 0), pool)
    r.op("audit", pool.assert_consistent, pool)


def scenario_prefetch_never_demotes(P, r):
    pool = P.mem.TieredPagePool(hbm_pages=2, host_pages=2)
    t = r.op("allocate", lambda: pool.allocate(1, 16 * 2), pool)
    r.op("shield one", lambda: pool.set_protected([t[2][1]]), pool)
    r.op("allocate", lambda: pool.allocate(2, 16), pool)
    cold = t[2][0]
    r.op("prefetch", lambda: pool.prefetch_promote(cold), pool)
    r.op("free", lambda: pool.free(2), pool)
    r.op("prefetch", lambda: pool.prefetch_promote(cold), pool)
    r.op("audit", pool.assert_consistent, pool)


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_leak_candidates, scenario_phantom_known_pin, scenario_peak_used_pages,
    scenario_take_demotes_coldest, scenario_protected_block_demotion,
    scenario_host_capacity, scenario_snapshot_forks_back,
    scenario_pinned_stay_demotable, scenario_cow_promotes_first,
    scenario_prefetch_never_demotes)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_pool_ops_match_jax(name):
    """The pool tests of ``tests/test_memory.py`` (lines 18-139), each as an
    op sequence on both packages' pools, compared after every op."""
    logs = {}
    for pkg, P in PKGS.items():
        r = Recorder(P)
        SCENARIOS[name](P, r)
        logs[pkg] = r.log
    assert logs["torch"] == logs["jax"]
    # the audits pass where JAX's tests say they pass
    audits = [e[1] for e in logs["torch"] if e[0] == "audit"]
    assert all(a == [] for a in audits)


HBM_BUDGET, HOST_BUDGET = 8, 24


def _workload_op(P, pool, live, pinned, kind, sid, tokens):
    """One op of ``tests/test_memory.py``'s random workload."""
    if kind == 0:                       # allocate or retire
        if sid in live:
            pool.free(sid)
            del live[sid]
        else:
            live[sid] = pool.allocate(sid, tokens)
    elif kind == 1 and sid in live:     # decode extend
        live[sid] = pool.extend(sid, tokens)
    elif kind == 2 and sid in live:     # prefix-cache pin + retire
        for p in live[sid].physical:
            if not pool.is_cache_pinned(p):
                pool.cache_ref(p)
                pinned.append(p)
        pool.free(sid)
        del live[sid]
    elif kind == 3 and pinned:          # fork from pinned prefix
        if sid not in live:
            share = list(dict.fromkeys(pinned))[: tokens // 16 or 1]
            live[sid] = pool.fork(sid, share, max(tokens, len(share) * 16))
    elif kind == 4 and sid in live:     # COW write
        pool.ensure_owned(sid, tokens % live[sid].n_pages)
        live[sid] = pool.table(sid)
    elif kind == 5 and sid in live:     # working-set refresh + LRU
        pool.set_protected(live[sid].physical[:HBM_BUDGET // 2])
        pool.touch(live[sid].physical)


@settings(max_examples=25, deadline=None)
@given(ops=st.lists(
    st.tuples(st.integers(0, 5), st.integers(0, 5), st.integers(1, 96)),
    min_size=1, max_size=60,
))
def test_random_workload_matches_jax(ops):
    """``tests/test_memory.py``'s interleavings of allocate / fork / extend /
    COW / free / pin / protect / touch under HBM overcommit, run in
    lock-step on both pools: the same exceptions, callbacks and state after
    every op; no protected page is ever demoted and the audit stays clean."""
    runs = {}
    for pkg, P in PKGS.items():
        pool = P.mem.TieredPagePool(HBM_BUDGET, HOST_BUDGET, page_size=16)
        r = Recorder(P)
        r.callbacks(pool)
        runs[pkg] = (P, pool, r, {}, [])
    for kind, sid_base, tokens in ops:
        for P, pool, r, live, pinned in runs.values():
            pool.tick()
            r.op((kind, sid_base, tokens), lambda: _workload_op(
                P, pool, live, pinned, kind, 100 + sid_base, tokens), pool)
            pool.assert_consistent()
        assert runs["torch"][2].log == runs["jax"][2].log
    P, pool, r, live, pinned = runs["torch"]
    demoted = [e for e in r.log if e[0] == "demote"]
    # active pages are never poisoned out from under a reader
    assert not any(e[3] for e in demoted)
    assert all(e[1] != "AssertionError" for e in r.log)
    for sid in list(live):
        pool.free(sid)
    for p in pinned:
        pool.cache_unref(p)
    assert pool.used_pages == 0 and pool.hbm_used == 0 and pool.host_used == 0
    assert all(t == tmem.FREE for t in pool._tier)
    assert len(demoted) == pool.demotions


# -- selected_page_masks ---------------------------------------------------------


@pytest.mark.parametrize("blocks", [(16, 32, 64, 32), (64, 64, 16, 16)])
@pytest.mark.parametrize("margin", [0, 2, 40])
def test_selected_page_masks_match_jax(blocks, margin):
    """Scores from four values (many ties), ragged lengths, margins of 0, 2
    and 40 (past every head's block count: ``k_wide`` is then the padded
    block count); both masks equal JAX's, ``predicted`` contains
    ``selected``."""
    ctx, budget = 512, 128
    jl, tl = j_layout_for(blocks, ctx, 16, budget), t_layout_for(blocks, ctx, 16, budget)
    la = as_arrays(tl)
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 4, (3, 4, jl.max_blocks)).astype(np.float32)
    seq_len = np.array([ctx, 301, 77], np.int32)
    kw = dict(sink_pages=1, local_pages=2, margin_blocks=margin,
              max_pages_per_block=max(blocks) // 16)
    js, jp = j_masks(jnp.asarray(scores), jl, jnp.asarray(seq_len), **kw)
    ts, tp = t_masks(torch.from_numpy(scores), la, torch.from_numpy(seq_len), **kw)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert ts.dtype == torch.bool and ts.shape == (3, la.n_pages)
    assert bool((tp | ~ts).all())
    if margin:
        assert int(tp.sum()) > int(ts.sum())


# -- engines -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, JAX params, port cfg, port model with the same weights)."""
    jcfg = j_smoke(j_get_config("llama3.2-3b"))
    tcfg = t_smoke(t_get_config("llama3.2-3b"))
    params = JTransformer(jcfg).init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


def _engine(pkg, cfg, weights, fused=True, **serve_kw):
    """An engine of ``pkg`` at temperature 0 whose clock reads its tick
    counter; the port decodes fused or staged on ``"cuda"`` (the kernels'
    plain versions here), JAX on ``"reference"``."""
    serve_kw = dict(temperature=0.0, **serve_kw)
    box = {}
    clock = lambda: float(box["eng"].metrics.ticks)     # noqa: E731
    if pkg == "jax":
        eng = clear_slots_on_install(JEngine(cfg, weights, JServe(**serve_kw),
                                             clock=clock))
    else:
        view = weights.with_sparse(backend="cuda", fused_decode=fused)
        eng = TEngine(view.cfg, view, TServe(**serve_kw), device="cpu", clock=clock)
    box["eng"] = eng
    return eng


def _requests(pkg, n, prompt_tokens, new_tokens, seed):
    Req = JRequest if pkg == "jax" else TRequest
    rng = np.random.default_rng(seed)
    return [Req(i, rng.integers(0, 256, prompt_tokens).astype(np.int32),
                max_new_tokens=new_tokens) for i in range(n)]


def _audit(eng):
    assert eng.pool.assert_consistent(known_pins=eng.prefix_cache.pages()) == []
    assert eng.pool.used_pages == eng.prefix_cache.n_pages


OVERCOMMIT = dict(max_batch=4, max_context=512, prefill_tokens_per_tick=512)


@pytest.fixture(scope="module")
def jax_overcommit(setup):
    """JAX's overcommitted run of ``tests/test_memory.py`` at temperature 0:
    3 x 300-token prompts (57 live pages) on 28 HBM + 68 host pages."""
    jcfg, params, _, _ = setup
    eng = _engine("jax", jcfg, params, hbm_pages=28, host_pages=68, **OVERCOMMIT)
    reqs = _requests("jax", 3, 300, 24, seed=7)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_ticks=500)
    return eng, [list(r.output) for r in reqs]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_overcommit_matches_flat_pool_and_jax(setup, jax_overcommit, fused):
    """Working set >= 2x the HBM budget: the port's tokens equal its flat
    pool's and the JAX engine's, with real migration traffic; every key of
    ``snapshot()`` (the tiering keys, ``migration_bytes`` included) equals
    JAX's; no leaks."""
    _, _, _, model = setup
    jeng, jout = jax_overcommit
    outs, engs = {}, {}
    for name, kw in (("tiered", dict(hbm_pages=28, host_pages=68)),
                     ("flat", dict(pool_pages=96))):
        eng = engs[name] = _engine("torch", None, model, fused, **kw, **OVERCOMMIT)
        reqs = _requests("torch", 3, 300, 24, seed=7)
        for r in reqs:
            eng.submit(r)
        eng.run_until_done(max_ticks=500)
        outs[name] = [list(r.output) for r in reqs]
        _audit(eng)
    assert outs["tiered"] == outs["flat"] == jout
    assert all(len(o) == 24 for o in jout)
    eng = engs["tiered"]
    assert eng.pool.demotions == jeng.pool.demotions > 0
    assert eng.pool.stats() == jeng.pool.stats()
    snap = eng.metrics.snapshot()
    assert snap == jeng.metrics.snapshot()
    assert snap["migration_bytes"] == snap["migrations"] * tmem.CachePageIO.page_nbytes(
        eng.cache["layers"]) > 0
    assert eng.pool.peak_hbm_pages <= 28 and eng.pool.max_live_seqs == 4
    assert "hbm_resident_pages" not in engs["flat"].metrics.snapshot()


def _forced_miss(pkg, cfg, weights, injector=None, max_ticks=300):
    """``tests/test_memory.py``'s forced miss: one 200-token request on 32
    HBM + 32 host pages; once it decodes with two tokens out, its sink page
    (pinned into every selection) is demoted around the shield.  With
    ``injector`` (a callable of the tick) the host link then breaks."""
    eng = _engine(pkg, cfg, weights, max_batch=2, max_context=512,
                  hbm_pages=32, host_pages=32)
    req = _requests(pkg, 1, 200, 8, seed=11)[0]
    eng.submit(req)
    forced = False
    for _ in range(max_ticks):
        if req.done:
            break
        seq = eng.scheduler.running.get(0)
        if not forced and seq is not None and seq.state == DECODE and len(req.output) >= 2:
            if demote_around_shield(eng, 0) is not None:
                if injector is not None:
                    eng.set_fault_injector(injector(eng.metrics.ticks))
                forced = True
        eng.step()
    assert forced and req.done
    return eng, list(req.output)


def _flat_baseline(model):
    eng = _engine("torch", None, model, max_batch=2, max_context=512, pool_pages=64)
    req = _requests("torch", 1, 200, 8, seed=11)[0]
    eng.submit(req)
    eng.run_until_done(max_ticks=200)
    return list(req.output)


def test_forced_miss_stalls_then_recovers(setup):
    """Demoting a page the next selection needs stalls only that sequence,
    promotes the page back, and the output equals the flat pool's and the
    JAX engine's; the stall, miss and migration counters equal JAX's."""
    jcfg, params, _, model = setup
    jeng, jout = _forced_miss("jax", jcfg, params)
    teng, tout = _forced_miss("torch", None, model)
    assert tout == jout == _flat_baseline(model)
    assert teng.metrics.stalls >= 1
    snap = teng.metrics.snapshot()
    assert snap["prefetch_misses"] >= 1
    assert snap == jeng.metrics.snapshot()
    _audit(teng)


def test_starvation_breaker_preempts_and_recovers_identical(setup):
    """The forced miss with the host link broken for the next ticks: every
    miss-promote fails, the starvation breaker preempts the sequence, and
    its resume reproduces the flat pool's stream; the JAX engine does the
    same (equal outputs and snapshots)."""
    jcfg, params, _, model = setup

    def storm(res):
        return lambda t: res.FaultInjector([res.FaultSpec("host_io", from_tick=t,
                                                          until_tick=t + 3)])

    jeng, jout = _forced_miss("jax", jcfg, params, storm(jres))
    teng, tout = _forced_miss("torch", None, model, storm(tres))
    assert tout == jout == _flat_baseline(model)
    snap = teng.metrics.snapshot()
    assert snap["host_io_errors"] >= 2, "host link never failed"
    assert teng.metrics.preemptions >= 1, "starvation breaker never fired"
    assert teng.metrics.stalls >= 1
    assert snap == jeng.metrics.snapshot()
    assert teng._fault.fired == jeng._fault.fired
    _audit(teng)


@pytest.mark.parametrize("serve,match", [
    (dict(max_context=64, hbm_pages=8, host_pages=8), "sparse"),
    (dict(max_context=512, pool_pages=64, hbm_pages=32, host_pages=32), "pool_pages"),
], ids=["dense-decode", "pool-pages"])
def test_tiered_construction_errors(setup, serve, match):
    """As JAX's: tiered memory needs the sparse decode path at max_context,
    and ``hbm_pages`` excludes ``pool_pages``."""
    jcfg, params, tcfg, model = setup
    with pytest.raises(ValueError, match=match):
        JEngine(jcfg, params, JServe(max_batch=2, **serve))
    with pytest.raises(ValueError, match=match):
        TEngine(tcfg, model, TServe(max_batch=2, **serve), device="cpu")


def test_page_io_round_trip_and_poison():
    """``CachePageIO`` over a two-layer bf16 cache: ``gather`` copies one
    slot's page across the layers, ``poison`` writes 9984 (1e4 in bf16) to
    that page only and in place, ``restore`` brings the bytes back
    bitwise; ``page_nbytes`` is JAX's formula."""
    gen = torch.Generator().manual_seed(0)
    layers = [{n: torch.randn((2, 3, 5, 16, 8), generator=gen).to(torch.bfloat16)
               for n in ("k", "v")} for _ in range(2)]
    before = [{n: t.clone() for n, t in e.items()} for e in layers]
    ptrs = [e["k"].data_ptr() for e in layers]
    io = tmem.CachePageIO()
    kb, vb = io.gather(layers, 1, 3)
    assert kb.shape == (2, 3, 16, 8)
    io.poison(layers, 1, 3)
    assert all(bool((e[n][1, :, 3] == 9984).all()) for e in layers for n in "kv")
    for e, b in zip(layers, before):
        for n in "kv":
            e_other = e[n].clone()
            e_other[1, :, 3] = b[n][1, :, 3]
            assert torch.equal(e_other, b[n])
    io.restore(layers, 1, 3, kb, vb)
    assert all(torch.equal(e[n], b[n]) for e, b in zip(layers, before) for n in "kv")
    assert [e["k"].data_ptr() for e in layers] == ptrs
    assert io.page_nbytes(layers) == 2 * 2 * 3 * 16 * 8 * 2


#: the slot-reuse runs: two 400-token prompts take both slots of a
#: max_batch 2 engine; a 100-token prompt then takes the slot of the first
#: to retire, whose rows reach past its own length
REUSE = dict(max_batch=2, max_context=512, prefill_tokens_per_tick=512)
REUSE_POOLS = {"flat": dict(pool_pages=64),
               "tiered": dict(hbm_pages=32, host_pages=32)}


def _slot_reuse(model, pool, prompts):
    """Serve ``prompts`` (8 new tokens each) in order on a port engine -> (outputs, the decode store (codes, scale, zero) of each
    request's slot right after its prefill, by request id, and whether the
    slot the last request took held another occupant's rows / poison)."""
    eng = _engine("torch", None, model, **REUSE_POOLS[pool], **REUSE)
    reqs = [TRequest(i, p, max_new_tokens=8) for i, p in enumerate(prompts)]
    stores, held = {}, {}
    refresh, install = eng.model.refresh_slot_store, eng._install

    def refresh_store(cache, slot):
        out = refresh(cache, slot)
        stores[eng.slots[slot].seq_id] = [
            tuple(e[n][slot].clone() for n in ("codes", "scale", "zero"))
            for e in cache["layers"]]
        return out

    def install_seq(adm):
        if adm.seq.seq_id == len(prompts) - 1:
            k = [e["k"][adm.slot] for e in eng.cache["layers"]]
            held.update(rows=any(bool(t.any()) for t in k),
                        poison=any(bool((t == tmem.POISON).any()) for t in k))
        install(adm)

    eng.model.refresh_slot_store, eng._install = refresh_store, install_seq
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_ticks=400)
    assert all(r.done for r in reqs)
    _audit(eng)
    return [list(r.output) for r in reqs], stores, held


@pytest.mark.parametrize("pool", ["flat", "tiered"])
def test_reused_slot_serves_as_a_fresh_slot(setup, pool):
    """A request admitted into a slot that a longer request used decodes
    as on a fresh engine: the same tokens, and after its prefill the same
    decode-store bytes, whose affine params span every block of the slot.
    Without the engine clearing a slot on install, the store quantizes
    against the previous occupant's rows past the new prompt; on a tiered
    pool some of those rows are poison (9984), left by a page that was
    host-resident when its sequence retired.  JAX's engine keeps such rows
    (``ROADMAP.md`` §3)."""
    _, _, _, model = setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (400, 400, 100)]
    out, stores, held = _slot_reuse(model, pool, prompts)
    assert held["rows"] and held["poison"] == (pool == "tiered")
    fresh_out, fresh_stores, _ = _slot_reuse(model, pool, prompts[2:])
    assert out[2] == fresh_out[0]
    for got, want in zip(stores[2], fresh_stores[0]):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
