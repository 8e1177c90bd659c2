"""Deterministic fault injection for the serving engine (a copy of
``repro.resilience.inject``; the plans and the firing rolls are the same).

A :class:`FaultInjector` holds a seeded, scheduleable fault plan — a list
of :class:`FaultSpec` entries keyed by injection *site*, tick window and
(optionally) sequence id — and is attached to a live engine with
``Engine.set_fault_injector``: with no injector installed every
injection point is a single ``is not None`` check and the hot path is
unchanged.

Injection sites (the failure domains of the serving stack):

``decode`` / ``prefill``
    Raise :class:`InjectedDeviceError` immediately before the step runs —
    a simulated device/kernel execution failure.  The engine's
    degradation ladder catches it (fused -> staged -> reference re-run for
    that tick); at the ladder floor the implicated sequences restore from
    their last checkpoint under the per-request failure budget.
``decode_nan``
    NaN-poison the sampled-from logits rows of matching sequences after
    the step — a simulated non-finite kernel output.  Detected by the
    hardened sampler (:class:`~repro_torch.serving.sampler.SamplerAnomaly`).
``pool_alloc``
    Raise :class:`~repro_torch.cache.paged_kv.PoolExhausted` out of
    ``PagePool._take`` — transient allocation failure.  Absorbed by the
    scheduler's existing admission-control / preemption paths.
``host_io``
    Raise :class:`HostIOError` from tiered KV memory's page I/O (a demotion's
    gather or a promotion's restore), before any migration state mutates —
    the page's bytes stay where they were.  Absorbed by the scheduler
    (``tier_bound``: preempt instead of evicting) and the memory manager
    (the staged promotion retries next tick).
``promote_delay``
    A staged host->HBM promotion sits out the tick (requeued): a slow host
    link.  The stalled sequence waits one more tick.
``tick_stuck``
    The whole scheduler tick elapses without running any phase — a stuck
    clock.  Detected by the engine's no-progress watchdog.

Firing is deterministic: probabilistic specs roll a counter-based RNG
keyed on ``(seed, spec, site, tick, seq_id, attempt)``, so two runs of the
same seeded plan against the same traffic inject the identical fault
sequence — the property the token-identity checks of a faulted run rest
on.
"""
from __future__ import annotations

import json
import zlib
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.cache.paged_kv import PoolExhausted

#: recognised injection sites (see module docstring).
SITES = (
    "decode",
    "decode_nan",
    "prefill",
    "pool_alloc",
    "host_io",
    "promote_delay",
    "tick_stuck",
)


class InjectedFault(RuntimeError):
    """Base class for injector-raised faults (never raised by real code)."""


class InjectedDeviceError(InjectedFault):
    """Simulated device / kernel execution failure."""


class HostIOError(PoolExhausted):
    """Simulated host-tier page I/O failure.

    Subclasses :class:`PoolExhausted` so every existing catch site
    (admission fork, decode reservation) already
    handles it as "this page operation did not happen, retry later";
    ``tier_bound`` short-circuits prefix-cache eviction — unpinning cached
    pages cannot fix a broken host link.
    """

    tier_bound = True


#: the step faults the degradation ladder catches besides the sampler's.
#: Deliberately no CUDA error type: an asynchronous kernel fault leaves the
#: CUDA context unusable, so a re-run on the next rung could not be
#: trusted, and a launch error (``kernels._build.check``) is a bug that a
#: degraded re-run would hide.  Both propagate and fail the run.
DEVICE_FAULTS: tuple = (InjectedDeviceError, FloatingPointError)


@dataclass
class FaultSpec:
    """One scheduled fault.  ``tick`` pins an exact tick; otherwise the
    spec is active on ticks in ``[from_tick, until_tick]`` where
    ``(tick - from_tick) % every == 0``.  ``seq_id`` restricts to one
    sequence (sites that carry one), ``p`` fires probabilistically (seeded,
    deterministic), and ``count`` caps total fires (``None`` = unlimited).
    """

    site: str
    tick: Optional[int] = None
    from_tick: int = 0
    until_tick: Optional[int] = None
    every: int = 1
    seq_id: Optional[int] = None
    p: float = 1.0
    count: Optional[int] = None
    #: fires so far (mutable bookkeeping, not part of the plan).
    fired: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; one of {SITES}")
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")

    def active(self, tick: int, seq_id: Optional[int]) -> bool:
        if self.count is not None and self.fired >= self.count:
            return False
        if self.tick is not None:
            if tick != self.tick:
                return False
        else:
            if tick < self.from_tick:
                return False
            if self.until_tick is not None and tick > self.until_tick:
                return False
            if (tick - self.from_tick) % self.every:
                return False
        if self.seq_id is not None and seq_id != self.seq_id:
            return False
        return True


def _site_id(site: str) -> int:
    return zlib.crc32(site.encode())


class FaultInjector:
    """Seeded, scheduleable fault plan (see module docstring)."""

    def __init__(
        self,
        specs: Sequence[Union[FaultSpec, dict]] = (),
        seed: int = 0,
    ):
        self.seed = int(seed)
        self.specs: List[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs
        ]
        #: site -> total fires (post-mortem / bench accounting).
        self.fired: Dict[str, int] = {}
        # per-(spec, tick, seq) query counter: repeated opportunities in
        # one tick (e.g. several pool allocations, ladder re-attempts) roll
        # independent — but still deterministic — probabilities.
        self._n: Dict[tuple, int] = {}

    # -- plan I/O ------------------------------------------------------------

    @classmethod
    def from_plan(cls, path: str, seed: int = 0) -> "FaultInjector":
        return cls(load_plan(path), seed=seed)

    def snapshot(self) -> Dict:
        return {
            "seed": self.seed,
            "specs": len(self.specs),
            "fired": dict(self.fired),
            "total_fired": sum(self.fired.values()),
        }

    # -- firing --------------------------------------------------------------

    def fires(self, site: str, tick: int, seq_id: Optional[int] = None) -> bool:
        """Consult (and consume) the plan for one fault opportunity."""
        hit = False
        for i, sp in enumerate(self.specs):
            if sp.site != site or not sp.active(tick, seq_id):
                continue
            if sp.p < 1.0:
                key = (i, tick, seq_id)
                n = self._n.get(key, 0)
                self._n[key] = n + 1
                roll = np.random.default_rng(
                    [
                        self.seed,
                        i,
                        _site_id(site),
                        tick,
                        0 if seq_id is None else seq_id + 1,
                        n,
                    ]
                ).random()
                if roll >= sp.p:
                    continue
            sp.fired += 1
            self.fired[site] = self.fired.get(site, 0) + 1
            hit = True
        return hit

    _RAISES = {
        "decode": InjectedDeviceError,
        "prefill": InjectedDeviceError,
        "host_io": HostIOError,
        "pool_alloc": PoolExhausted,
    }

    def check_raise(
        self,
        site: str,
        tick: int,
        seq_id: Optional[int] = None,
        detail: str = "",
    ):
        """Raise the site's fault type if the plan fires here."""
        if self.fires(site, tick, seq_id):
            exc = self._RAISES[site](
                f"injected {site} fault at tick {tick}"
                + (f" seq {seq_id}" if seq_id is not None else "")
                + (f" ({detail})" if detail else "")
            )
            raise exc

    def poison_rows(self, tick: int, seq_slots) -> List[int]:
        """Slots of ``(seq_id, slot)`` pairs whose logits this tick's
        ``decode_nan`` specs poison."""
        return [
            slot
            for sid, slot in seq_slots
            if self.fires("decode_nan", tick, sid)
        ]


def load_plan(path: str) -> List[FaultSpec]:
    """Load a JSON fault plan: a list of :class:`FaultSpec` dicts."""
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, list):
        raise ValueError(f"fault plan {path} must be a JSON list of specs")
    return [FaultSpec(**{k: v for k, v in d.items() if k != "fired"})
            for d in raw]


def dump_plan(specs: Sequence[FaultSpec], path: str):
    with open(path, "w") as f:
        json.dump([asdict(s) for s in specs], f, indent=2)


def default_storm() -> List[FaultSpec]:
    """The stock mixed fault storm behind ``serve --chaos-seed`` with no
    ``--chaos-plan``: a few of every fault class, all bounded, so a smoke
    run exercises every failure domain and still drains clean."""
    return [
        FaultSpec("decode", tick=5, count=1),
        FaultSpec("decode_nan", from_tick=3, until_tick=60, every=7, count=3),
        FaultSpec("prefill", tick=2, count=1),
        FaultSpec("pool_alloc", from_tick=4, until_tick=40, every=9, count=2),
        FaultSpec("host_io", from_tick=6, until_tick=30, every=5, count=3),
        FaultSpec("promote_delay", from_tick=2, until_tick=40, every=4,
                  count=4),
        FaultSpec("tick_stuck", tick=11, count=1),
    ]
