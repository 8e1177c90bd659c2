"""Per-tick records of a serving run, for checks of what the engine ran.

:class:`LadderProbe` wraps an :class:`~repro_torch.serving.engine.Engine`'s
rung step functions and is passed as ``run_until_done``'s
``tick_callback``: it records, by tick, each model step with its rung, the
kernel launches of the tick and the degradations so far, and decides which
ticks are a rung's *whole decode ticks* (:meth:`LadderProbe.whole_decode_ticks`).
:class:`SampleRecorder` wraps the engine's sampler and records each sampled
row's logits, token and tick by (request, position), optionally feeding
given tokens in place of the samples.  Detach both after the run
(``detach()``): that restores the engine and drops every reference to it,
so a kept record does not keep the engine's cache alive.
:func:`demote_around_shield` forces a tiered engine's page to the host
tier, for checks of the miss path.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch import kernels
from repro_torch.memory import HBM
from repro_torch.serving.scheduler import DECODE


class _Patch:
    """Sets ``engine.<name>`` to ``fn`` until :meth:`detach`."""

    def _patch(self, engine, name: str, fn):
        self._engine, self._name = engine, name
        self._had = name in engine.__dict__
        self._old = engine.__dict__.get(name)
        setattr(engine, name, fn)

    def detach(self):
        if self._had:
            setattr(self._engine, self._name, self._old)
        else:
            delattr(self._engine, self._name)
        self._engine = self._old = None


class LadderProbe(_Patch):
    """Records, by tick, what ``engine``'s ladder ran.

    - ``steps[tick]``: ``(rung, "decode" | "chunk", decoding request ids)``
      for every model step in the order they ran (a fault raised before a
      step leaves no entry);
    - ``launches[tick]``: kernel name -> launches during the tick, read as
      deltas of :func:`repro_torch.kernels.counts` (reset the counts just
      before the run: the first tick's delta is taken from 0);
    - ``degradations[tick]``: the engine's degradations so far.

    ``decode_hook(rung, call)``, if given, runs each decode step (the
    zero-argument ``call``) and returns its result, e.g. to time it."""

    def __init__(self, engine, decode_hook: Optional[Callable] = None):
        self.steps: Dict[int, List[Tuple[int, str, List[int]]]] = {}
        self.launches: List[Dict[str, int]] = []
        self.degradations: List[int] = []
        self._last: Dict[str, int] = {}
        inner = engine._rung_step_fns

        def fns(rung):
            decode, chunk = inner(rung)

            def probed_decode(*a, **k):
                ids = [s.seq_id for s in engine.slots
                       if s is not None and s.state == DECODE]
                self._note(engine, rung, "decode", ids)
                if decode_hook is None:
                    return decode(*a, **k)
                return decode_hook(rung, lambda: decode(*a, **k))

            def probed_chunk(*a, **k):
                self._note(engine, rung, "chunk", [])
                return chunk(*a, **k)

            return probed_decode, probed_chunk

        self._patch(engine, "_rung_step_fns", fns)

    def _note(self, engine, rung, kind, ids):
        self.steps.setdefault(engine.metrics.ticks, []).append((rung, kind, ids))

    def __call__(self, engine, tick: int):
        now = {n: c["launches"] for n, c in kernels.counts().items()}
        self.launches.append({n: c - self._last.get(n, 0) for n, c in now.items()})
        self._last = now
        self.degradations.append(sum(engine.metrics.degradations.values()))

    def whole_decode_ticks(self) -> Dict[int, List[int]]:
        """-> {rung: [tick, ...]}: the ticks whose steps all ran on one rung,
        with exactly one decode step and no degradation.  A fault raised
        before its step runs leaves no step behind, so the tick's
        degradation count is read too: such a tick's launches are those
        of its rung alone."""
        out: Dict[int, List[int]] = {}
        for t, steps in sorted(self.steps.items()):
            rungs = {r for r, _, _ in steps}
            before = self.degradations[t - 1] if t else 0
            if (len(rungs) == 1 and [k for _, k, _ in steps].count("decode") == 1
                    and self.degradations[t] == before):
                out.setdefault(rungs.pop(), []).append(t)
        return out


class SampleRecorder(_Patch):
    """Records every row ``engine`` samples: ``logits[(request, position)]``
    (f32, on the host), the token committed there (``tokens``) and the tick
    it was last sampled at (``ticks``).  With ``forced`` ({(request,
    position): token}) the engine is fed those tokens in place of its own
    samples."""

    def __init__(self, engine, forced: Optional[Dict] = None):
        self.logits: Dict[Tuple[int, int], object] = {}
        self.tokens: Dict[Tuple[int, int], int] = {}
        self.ticks: Dict[Tuple[int, int], int] = {}
        sample = engine._sample

        def recording(seq_ids, positions, lg):
            toks, fin = sample(seq_ids, positions, lg)
            for r, key in enumerate(zip(seq_ids, positions)):
                self.logits[key] = lg[r].float().cpu()
                if forced is not None:
                    toks[r] = forced[key]
                self.tokens[key] = int(toks[r])
                self.ticks[key] = engine.metrics.ticks
            return toks, fin

        self._patch(engine, "_sample", recording)


#: the tiering counters of ``ServingMetrics.snapshot()`` that two runs of
#: one traffic on one pool must share (graphed and eager, say)
TIER_COUNTERS = ("stalls", "prefetch_hits", "prefetch_misses", "prefetch_staged",
                 "migrations", "migration_bytes")


def demote_around_shield(engine, seq_id: int) -> Optional[int]:
    """Demote ``seq_id``'s sink page (its first, pinned into every
    selection) to the host tier past the demotion shield, when it is
    device-resident -> the page, else None.  The next step misses on it.
    A host-I/O error of the copy propagates."""
    pool = engine.pool
    page = pool.table(seq_id).physical[0]
    if pool.tier_of(page) != HBM:
        return None
    pool._protected.discard(page)
    pool._auto_protected.discard(page)
    pool._demote(page)
    return page
