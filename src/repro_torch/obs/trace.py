"""Low-overhead execution tracing for the serving stack (counterpart of
``repro.obs.trace``).

A :class:`TraceRecorder` is a bounded ring buffer of timeline events —
duration spans, begin/end pairs for spans whose end is not known at entry
(sequence lifecycle phases, host-tier stalls), instant markers and counter
samples.  The clock is injectable (the engine shares its metrics clock, so
tests drive a deterministic virtual timeline); production uses
``time.monotonic``.

Recording is cheap on purpose: one dataclass append per event, no
serialization, no device interaction.  When the buffer is full the oldest
events are evicted (``dropped`` counts them) — a trace of the *recent* past
is always available without unbounded memory.

Export (:meth:`TraceRecorder.to_chrome` / :meth:`TraceRecorder.dump`)
produces Chrome trace-event JSON loadable in Perfetto (ui.perfetto.dev) or
``chrome://tracing``.  Track layout:

- pid ``scheduler``: admission / preemption instants, queue-depth counters,
- pid ``engine``: per-tick spans with admit / prefill-chunk / decode
  sub-spans,
- pid ``sequences``: ONE thread per request (tid == request id) carrying
  its lifecycle phase spans (``seq.queued -> seq.prefill -> seq.decode``,
  ``seq.stall`` nested inside decode, ``seq.preempt`` instants),
- pid ``memory``: migration / prefetch instants plus ``pool`` and
  ``residency`` counter tracks,
- pid ``kernels``: per-step sparsity counter tracks (blocks attended,
  pages gathered, budget utilization).
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

#: Perfetto process-group ids, one per subsystem.
PID_SCHED = 1
PID_ENGINE = 2
PID_MEMORY = 3
PID_SEQ = 4
PID_KERNEL = 5

PROCESS_NAMES = {
    PID_SCHED: "scheduler",
    PID_ENGINE: "engine",
    PID_MEMORY: "memory",
    PID_SEQ: "sequences",
    PID_KERNEL: "kernels",
}


@dataclass(slots=True)
class TraceEvent:
    """One timeline event (times in recorder-clock seconds).

    Slotted: a full ring holds ``capacity`` of these, and slots keep both
    the per-event footprint and GC scan cost down."""

    name: str
    ph: str                       # "X" | "B" | "E" | "i" | "C"
    ts: float
    pid: int
    tid: int
    dur: Optional[float] = None   # "X" only
    args: Optional[Dict[str, Any]] = None


class TraceRecorder:
    """Ring-buffered span/instant/counter recorder with Chrome export."""

    def __init__(
        self,
        capacity: int = 65536,
        clock: Callable[[], float] = time.monotonic,
    ):
        assert capacity > 0, capacity
        self.capacity = capacity
        self.clock = clock
        self._events: deque = deque(maxlen=capacity)
        #: events evicted from the ring (oldest-first) since creation.
        self.dropped = 0
        # (pid, tid) -> display name; kept OUTSIDE the ring so eviction
        # never loses track naming (emitted as metadata at export time).
        self._thread_names: Dict[tuple, str] = {}
        self._flush_hooks: list = []

    def __len__(self) -> int:
        return len(self._events)

    def events(self):
        """Current ring contents, oldest first (a snapshot list)."""
        return list(self._events)

    # -- recording -----------------------------------------------------------

    def _push(self, ev: TraceEvent):
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    @contextmanager
    def span(self, name: str, pid: int, tid: int = 0, args: Optional[dict] = None):
        """Scoped duration span: records ONE complete ("X") event at exit,
        so ring eviction can never leave a dangling half-span."""
        t0 = self.clock()
        try:
            yield self
        finally:
            self._push(TraceEvent(
                name, "X", t0, pid, tid, dur=self.clock() - t0, args=args
            ))

    def begin(self, name: str, pid: int, tid: int = 0,
              args: Optional[dict] = None):
        """Open span whose end is not known at entry (lifecycle phases,
        stalls).  Pair with :meth:`end` on the same (pid, tid) — spans on
        one track close innermost-first (stack discipline)."""
        self._push(TraceEvent(name, "B", self.clock(), pid, tid, args=args))

    def end(self, name: str, pid: int, tid: int = 0):
        self._push(TraceEvent(name, "E", self.clock(), pid, tid))

    def instant(self, name: str, pid: int, tid: int = 0,
                args: Optional[dict] = None):
        self._push(TraceEvent(name, "i", self.clock(), pid, tid, args=args))

    def counter(self, name: str, values: Dict[str, float], pid: int = PID_MEMORY):
        """Sample a counter track: ``values`` maps series name -> value."""
        self._push(TraceEvent(
            name, "C", self.clock(), pid, 0, args=dict(values)
        ))

    def counter_at(self, name: str, values: Dict[str, float], ts: float,
                   pid: int = PID_MEMORY):
        """Counter sample with an explicit (recorder-clock) timestamp.
        Trace-event JSON carries ts per event (viewers sort by it), so
        deferred emitters can batch hot-path samples and push them late —
        see :meth:`add_flush_hook`."""
        self._push(TraceEvent(name, "C", ts, pid, 0, args=dict(values)))

    def add_flush_hook(self, fn: Callable[[], None]):
        """Register ``fn()`` to run at export time, before serialization.
        Deferred emitters (e.g. the engine's per-step sparsity counters)
        queue raw samples on the hot path and materialize events here."""
        self._flush_hooks.append(fn)

    def name_thread(self, pid: int, tid: int, name: str):
        self._thread_names.setdefault((pid, tid), name)

    # -- export --------------------------------------------------------------

    def to_chrome(self) -> dict:
        """-> Chrome trace-event JSON object (Perfetto-loadable).

        Timestamps are microseconds relative to the earliest retained
        event; counter/instant semantics follow the trace-event spec.
        Flush hooks run first, so deferred emitters land in the export.
        """
        for fn in self._flush_hooks:
            fn()
        evs = list(self._events)
        t0 = min((e.ts for e in evs), default=0.0)
        out = []
        for pid, pname in PROCESS_NAMES.items():
            out.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": pname},
            })
        for (pid, tid), name in self._thread_names.items():
            out.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name},
            })
        for e in evs:
            rec: Dict[str, Any] = {
                "name": e.name, "ph": e.ph,
                "ts": (e.ts - t0) * 1e6,
                "pid": e.pid, "tid": e.tid,
            }
            if e.ph == "X":
                rec["dur"] = max(e.dur or 0.0, 0.0) * 1e6
            if e.ph == "i":
                rec["s"] = "t"                    # thread-scoped instant
            if e.args is not None:
                rec["args"] = e.args
            out.append(rec)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "dropped_events": self.dropped,
                "capacity": self.capacity,
            },
        }

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")
        return path
