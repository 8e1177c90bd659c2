"""Request-lifecycle metrics for the serving scheduler (counterpart of
``repro.serving.metrics``).

Per-request timeline (submit -> admit -> first token -> finish) plus fleet
counters (prefill tokens computed vs. skipped via the prefix cache,
preemptions, decode tokens).  The clock is injectable so engine tests can
drive a deterministic virtual clock; production uses ``time.monotonic``.

Latency definitions (the standard serving ones):
- TTFT  = first-token time - submit time (includes queueing),
- TPOT  = (finish - first token) / (output tokens - 1),
- queue = first admission time - submit time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs.trace import PID_ENGINE, PID_MEMORY, PID_SEQ, TraceRecorder


@dataclass
class RequestMetrics:
    req_id: int
    prompt_tokens: int = 0
    output_tokens: int = 0
    #: SLO class (``interactive`` / ``batch`` / ``deadline``); drives the
    #: per-class latency aggregation in :meth:`ServingMetrics.snapshot`.
    slo_class: str = "interactive"
    #: absolute effective deadline (t_submit + SLO target / deadline_s);
    #: ``None`` until the scheduler stamps it at submit.
    deadline: Optional[float] = None
    #: prompt tokens whose prefill was skipped via the prefix cache
    #: (accumulated across re-admissions after preemption).
    prefix_hit_tokens: int = 0
    preemptions: int = 0
    #: host-tier misses: ticks spent stalled waiting for page promotion
    #: (tiered KV memory only; see :mod:`repro_torch.memory`).
    stalls: int = 0
    stall_time: float = 0.0
    #: step-fault retries charged against this request's failure budget.
    retries: int = 0
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None          # first admission
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None

    @property
    def queue_time(self) -> Optional[float]:
        if self.t_admit is None or self.t_submit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None or self.t_submit is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tpot(self) -> Optional[float]:
        if self.t_finish is None or self.t_first_token is None:
            return None
        if self.output_tokens <= 1:
            return 0.0
        return (self.t_finish - self.t_first_token) / (self.output_tokens - 1)

    @property
    def deadline_missed(self) -> bool:
        """Whether this request blew its effective deadline.

        ``interactive`` / ``batch`` miss on first-token time (their deadline
        is a TTFT SLO target); the ``deadline`` class misses on completion
        time.  Unfinished requests never count as misses — the miss rate in
        :meth:`ServingMetrics.snapshot` covers completed requests only.
        """
        if self.deadline is None:
            return False
        if self.slo_class == "deadline":
            return self.t_finish is not None and self.t_finish > self.deadline
        return (
            self.t_first_token is not None
            and self.t_first_token > self.deadline
        )


def _pct(xs: List[float], q: float) -> float:
    """Nearest-rank percentile.  Pure Python on purpose: this is a
    hot-path-free bookkeeping module, and a numpy dependency here would be
    overkill.  Empty input -> 0.0 (an empty-run snapshot must stay
    all-zeros and JSON-serializable, never raise or produce NaN)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[idx]


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


class ServingMetrics:
    """Engine-level metrics recorder + aggregate snapshot."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        #: optional :class:`~repro_torch.obs.trace.TraceRecorder`.  When set, the
        #: lifecycle events below double as per-sequence timeline spans (one
        #: Perfetto track per request: queued -> prefill -> decode, stalls
        #: nested inside decode, preemption instants) — the engine wires
        #: this up so every subsystem traces through one recorder.
        self.trace: Optional[TraceRecorder] = None
        #: optional :class:`~repro_torch.obs.telemetry.SparsityAggregate`; decode
        #: and prefill sparsity counters fold in via :meth:`on_sparsity` /
        #: :meth:`on_prefill_sparsity` and surface in :meth:`snapshot`.
        self.sparsity = None
        self._phase: Dict[int, str] = {}     # req_id -> open lifecycle span
        self._stall_open: set = set()        # req_ids with an open stall span
        self.requests: Dict[int, RequestMetrics] = {}
        self.ticks = 0
        self.prefill_tokens_computed = 0
        self.prefix_hit_tokens = 0
        self.decode_tokens = 0
        self.preemptions = 0
        #: admissions deferred by prefix-cache-aware batching (a queued
        #: request waited for a prefilling peer's shared prefix to land in
        #: the radix cache before admitting).
        self.prefix_deferrals = 0
        # -- memory tiering (populated only when the engine runs a
        # TieredPagePool; ``tiering`` gates the snapshot fields) --
        self.tiering = False
        self.hbm_resident_pages = 0
        self.host_resident_pages = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.prefetch_staged = 0
        self.migrations = 0
        self.migration_bytes = 0
        self.stalls = 0
        self._stall_start: Dict[int, float] = {}
        # -- failure domains (repro_torch.resilience); always present so the
        # snapshot carries the counters whether or not faults ever fire --
        self.retries = 0
        self.replayed_tokens = 0
        self.checkpoints_taken = 0
        self.checkpoints_restored = 0
        self.degradations: Dict[str, int] = {}      # rung name -> count
        self.repromotions = 0
        self.watchdog_fires = 0
        self.sampler_anomalies = 0
        self.host_io_errors = 0
        self.requests_failed: Dict[int, str] = {}   # req_id -> reason

    def _req(self, req_id: int) -> RequestMetrics:
        return self.requests.setdefault(req_id, RequestMetrics(req_id))

    def _set_phase(self, req_id: int, phase: Optional[str]):
        """Transition a request's lifecycle span on its Perfetto track.

        Closes any open stall span first (spans on one track nest, and a
        stall only ever lives inside decode), then ends the previous phase
        and begins the new one.  No-op without a trace or on a repeat."""
        if self.trace is None:
            return
        prev = self._phase.get(req_id)
        if prev == phase:
            return
        if req_id in self._stall_open:
            self.trace.end("seq.stall", PID_SEQ, req_id)
            self._stall_open.discard(req_id)
        if prev is not None:
            self.trace.end(prev, PID_SEQ, req_id)
        if phase is not None:
            self.trace.begin(phase, PID_SEQ, req_id)
            self._phase[req_id] = phase
        else:
            self._phase.pop(req_id, None)

    # -- lifecycle events ----------------------------------------------------

    def on_submit(
        self, req_id: int, prompt_tokens: int,
        slo_class: str = "interactive",
    ) -> RequestMetrics:
        r = self._req(req_id)
        r.prompt_tokens = prompt_tokens
        r.slo_class = slo_class
        if r.t_submit is None:
            r.t_submit = self.clock()
        if self.trace is not None:
            self.trace.name_thread(PID_SEQ, req_id, f"req {req_id}")
        self._set_phase(req_id, "seq.queued")
        # the scheduler stamps r.deadline from t_submit + the SLO target.
        return r

    def on_admit(self, req_id: int, prefix_hit_tokens: int = 0):
        r = self._req(req_id)
        if r.t_admit is None:
            r.t_admit = self.clock()
        r.prefix_hit_tokens += prefix_hit_tokens
        self.prefix_hit_tokens += prefix_hit_tokens
        if self.trace is not None and prefix_hit_tokens:
            self.trace.instant(
                "prefix.hit", PID_SEQ, req_id,
                args={"reused_tokens": prefix_hit_tokens},
            )
        self._set_phase(req_id, "seq.prefill")

    def on_prefix_defer(self, req_id: int):
        """Admission of ``req_id`` deferred to wait for a shared-prefix peer
        still in prefill (prefix-cache-aware batching)."""
        self.prefix_deferrals += 1
        if self.trace is not None:
            self.trace.instant("prefix.defer", PID_SEQ, req_id)

    def on_prefill(self, n_tokens: int):
        self.prefill_tokens_computed += n_tokens

    def on_first_token(self, req_id: int):
        r = self._req(req_id)
        if r.t_first_token is None:
            r.t_first_token = self.clock()
        self._set_phase(req_id, "seq.decode")

    def on_decode_token(self, req_id: int):
        self._req(req_id).output_tokens += 1
        self.decode_tokens += 1

    def on_preempt(self, req_id: int):
        self._req(req_id).preemptions += 1
        self.preemptions += 1
        # the engine preempts BEFORE memory.forget fires on_stall_end, so
        # _set_phase closes any open stall span here (stack discipline).
        self._set_phase(req_id, "seq.queued")
        if self.trace is not None:
            self.trace.instant("seq.preempt", PID_SEQ, req_id)

    def on_finish(self, req_id: int):
        # idempotent like every other lifecycle event: a duplicate retire
        # must not overwrite t_finish (it would skew TPOT).
        r = self._req(req_id)
        if r.t_finish is None:
            r.t_finish = self.clock()
        self._set_phase(req_id, None)

    # -- memory tiering events -----------------------------------------------

    def set_residency(self, hbm_pages: int, host_pages: int):
        self.tiering = True
        self.hbm_resident_pages = hbm_pages
        self.host_resident_pages = host_pages

    def on_prefetch_hit(self, n: int = 1):
        self.prefetch_hits += n
        if self.trace is not None:
            self.trace.instant("prefetch.hit", PID_MEMORY, args={"pages": n})

    def on_prefetch_miss(self, n: int = 1):
        self.prefetch_misses += n
        if self.trace is not None:
            self.trace.instant("prefetch.miss", PID_MEMORY, args={"pages": n})

    def on_prefetch_staged(self, n: int = 1):
        self.prefetch_staged += n
        if self.trace is not None:
            self.trace.instant("prefetch.stage", PID_MEMORY, args={"pages": n})

    def on_migration(self, nbytes: int, demote: bool):
        self.migrations += 1
        self.migration_bytes += nbytes
        if self.trace is not None:
            self.trace.instant(
                "mem.demote" if demote else "mem.promote",
                PID_MEMORY, args={"bytes": nbytes},
            )

    def on_stall_begin(self, req_id: int):
        r = self._req(req_id)
        r.stalls += 1
        self.stalls += 1
        self._stall_start.setdefault(req_id, self.clock())
        if self.trace is not None and req_id not in self._stall_open:
            self.trace.begin("seq.stall", PID_SEQ, req_id)
            self._stall_open.add(req_id)

    def on_stall_end(self, req_id: int):
        t0 = self._stall_start.pop(req_id, None)
        if t0 is not None:
            self._req(req_id).stall_time += self.clock() - t0
        # no-op if _set_phase already closed the span (preempt-while-stalled)
        if self.trace is not None and req_id in self._stall_open:
            self.trace.end("seq.stall", PID_SEQ, req_id)
            self._stall_open.discard(req_id)

    # -- failure domains (repro_torch.resilience) ----------------------------

    def on_retry(self, req_id: int, reason: str):
        self._req(req_id).retries += 1
        self.retries += 1
        if self.trace is not None:
            self.trace.instant(
                "seq.retry", PID_SEQ, req_id, args={"reason": reason}
            )

    def on_checkpoint(self, req_id: int):
        self.checkpoints_taken += 1

    def on_replay_token(self, req_id: int):
        """A resumed sequence rebuilt one committed token's KV through the
        decode path (forced input, sample discarded)."""
        self.replayed_tokens += 1

    def on_restore(self, req_id: int):
        """Checkpoint restore: the request re-queues (backoff) with its
        output truncated to the last checkpoint's watermark."""
        self.checkpoints_restored += 1
        self._set_phase(req_id, "seq.queued")
        if self.trace is not None:
            self.trace.instant("seq.restore", PID_SEQ, req_id)

    def on_degrade(self, rung: str, reason: str):
        self.degradations[rung] = self.degradations.get(rung, 0) + 1
        if self.trace is not None:
            self.trace.instant(
                "engine.degrade", PID_ENGINE,
                args={"rung": rung, "reason": reason},
            )

    def on_repromote(self, rung: str):
        self.repromotions += 1
        if self.trace is not None:
            self.trace.instant(
                "engine.repromote", PID_ENGINE, args={"rung": rung}
            )

    def on_watchdog(self, idle_ticks: int):
        self.watchdog_fires += 1
        if self.trace is not None:
            self.trace.instant(
                "engine.watchdog", PID_ENGINE,
                args={"idle_ticks": idle_ticks},
            )

    def on_sampler_anomaly(self, n: int = 1):
        self.sampler_anomalies += n

    def on_host_io_error(self, op: str):
        self.host_io_errors += 1
        if self.trace is not None:
            self.trace.instant("mem.io_error", PID_MEMORY, args={"op": op})

    def on_request_failed(self, req_id: int, reason: str):
        """Failure budget exhausted: terminal, with a structured reason.
        The request is NOT counted as finished (t_finish stays unset) so
        latency aggregates only cover completed requests."""
        self.requests_failed[req_id] = reason
        self._set_phase(req_id, None)
        if self.trace is not None:
            self.trace.instant(
                "seq.failed", PID_SEQ, req_id, args={"reason": reason}
            )

    # -- device-side sparsity telemetry (repro_torch.obs) --------------------

    def on_sparsity(self, tel, slots):
        """Fold one decode tick's ``[n_layers, B, 4]`` counter array (a
        fresh host copy, kept until the next snapshot)."""
        if self.sparsity is not None:
            self.sparsity.update_decode(tel, slots)

    def on_prefill_sparsity(self, attended, candidates=None):
        """Fold one prefill chunk's per-layer attended-block counts."""
        if self.sparsity is not None:
            self.sparsity.update_prefill(attended, candidates)

    # -- aggregation ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Aggregate view over finished requests (plus fleet counters)."""
        done = [r for r in self.requests.values() if r.t_finish is not None]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        tpots = [r.tpot for r in done if r.tpot is not None]
        queues = [r.queue_time for r in done if r.queue_time is not None]
        # hit rate over the same fleet counters as the token fields, so a
        # mid-run snapshot is self-consistent: every prompt token either
        # came from the prefix cache or was prefill-computed.
        processed = self.prefix_hit_tokens + self.prefill_tokens_computed
        snap: Dict[str, float] = {
            "requests_finished": len(done),
            "ticks": self.ticks,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "decode_tokens": self.decode_tokens,
            "preemptions": self.preemptions,
            "prefix_deferrals": self.prefix_deferrals,
            "prefix_hit_rate": (
                self.prefix_hit_tokens / processed if processed else 0.0
            ),
        }
        # latency keys are ALWAYS present (zero on an empty run) so
        # downstream JSON consumers never key-error on a snapshot.
        snap["ttft_mean"] = _mean(ttfts)
        snap["ttft_p50"] = _pct(ttfts, 0.50)
        snap["ttft_p95"] = _pct(ttfts, 0.95)
        snap["ttft_p99"] = _pct(ttfts, 0.99)
        snap["tpot_mean"] = _mean(tpots)
        snap["tpot_p50"] = _pct(tpots, 0.50)
        snap["tpot_p95"] = _pct(tpots, 0.95)
        snap["tpot_p99"] = _pct(tpots, 0.99)
        snap["queue_time_mean"] = _mean(queues)
        # -- SLO accounting: overall + per-class latency/deadline-miss
        # aggregates, always present and JSON-safe on an empty run --
        misses = sum(1 for r in done if r.deadline_missed)
        snap["deadline_misses"] = misses
        snap["deadline_miss_rate"] = misses / len(done) if done else 0.0
        per_class: Dict[str, Dict[str, float]] = {}
        for cls in sorted({r.slo_class for r in done}):
            cdone = [r for r in done if r.slo_class == cls]
            cttft = [r.ttft for r in cdone if r.ttft is not None]
            ctpot = [r.tpot for r in cdone if r.tpot is not None]
            cmiss = sum(1 for r in cdone if r.deadline_missed)
            per_class[cls] = {
                "finished": len(cdone),
                "ttft_p50": _pct(cttft, 0.50),
                "ttft_p95": _pct(cttft, 0.95),
                "ttft_p99": _pct(cttft, 0.99),
                "tpot_p50": _pct(ctpot, 0.50),
                "tpot_p95": _pct(ctpot, 0.95),
                "tpot_p99": _pct(ctpot, 0.99),
                "deadline_misses": cmiss,
                "deadline_miss_rate": cmiss / len(cdone) if cdone else 0.0,
            }
        snap["per_class"] = per_class
        # failure counters are ALWAYS present too (zero / empty when no
        # faults fired) — chaos tooling and the bench gate key on them.
        failed_by_reason: Dict[str, int] = {}
        for reason in self.requests_failed.values():
            failed_by_reason[reason] = failed_by_reason.get(reason, 0) + 1
        snap["retries"] = self.retries
        snap["replayed_tokens"] = self.replayed_tokens
        snap["checkpoints_taken"] = self.checkpoints_taken
        snap["checkpoints_restored"] = self.checkpoints_restored
        snap["degradations"] = sum(self.degradations.values())
        snap["degradations_by_rung"] = dict(self.degradations)
        snap["repromotions"] = self.repromotions
        snap["watchdog_fires"] = self.watchdog_fires
        snap["sampler_anomalies"] = self.sampler_anomalies
        snap["host_io_errors"] = self.host_io_errors
        snap["requests_failed"] = len(self.requests_failed)
        snap["failed_by_reason"] = failed_by_reason
        if self.sparsity is not None:
            snap.update(self.sparsity.snapshot())
        if self.tiering:
            lookups = self.prefetch_hits + self.prefetch_misses
            stall_times = [r.stall_time for r in done]
            snap["hbm_resident_pages"] = self.hbm_resident_pages
            snap["host_resident_pages"] = self.host_resident_pages
            snap["prefetch_hits"] = self.prefetch_hits
            snap["prefetch_misses"] = self.prefetch_misses
            snap["prefetch_staged"] = self.prefetch_staged
            snap["prefetch_hit_rate"] = (
                self.prefetch_hits / lookups if lookups else 0.0
            )
            snap["migrations"] = self.migrations
            snap["migration_bytes"] = self.migration_bytes
            snap["stalls"] = self.stalls
            snap["stall_time_total"] = sum(
                r.stall_time for r in self.requests.values()
            )
            if stall_times:
                snap["stall_time_mean"] = sum(stall_times) / len(stall_times)
                snap["stall_time_max"] = max(stall_times)
        return snap

    def format_snapshot(self) -> str:
        snap = self.snapshot()
        parts = [
            f"finished={snap['requests_finished']:.0f}",
            f"ticks={snap['ticks']:.0f}",
            f"prefill_computed={snap['prefill_tokens_computed']:.0f}tok",
            f"prefix_hits={snap['prefix_hit_tokens']:.0f}tok "
            f"({100 * snap['prefix_hit_rate']:.1f}%)",
            f"decode={snap['decode_tokens']:.0f}tok",
            f"preemptions={snap['preemptions']:.0f}",
        ]
        if snap["requests_finished"]:
            parts.append(
                f"ttft p50/p95={snap['ttft_p50'] * 1e3:.0f}/"
                f"{snap['ttft_p95'] * 1e3:.0f}ms"
            )
            parts.append(f"tpot={snap['tpot_mean'] * 1e3:.1f}ms")
            parts.append(f"queue={snap['queue_time_mean'] * 1e3:.0f}ms")
        if self.sparsity is not None and snap.get("sparsity_steps"):
            parts.append(
                f"sparsity blocks/step={snap['blocks_per_step']:.0f} "
                f"pages/step={snap['pages_per_step']:.0f} "
                f"budget_util={100 * snap['budget_utilization']:.0f}% "
                f"forced={100 * snap['forced_frac']:.0f}%"
            )
        if self.tiering:
            parts.append(
                f"mem hbm/host={snap['hbm_resident_pages']:.0f}/"
                f"{snap['host_resident_pages']:.0f}pg "
                f"prefetch hit/miss={snap['prefetch_hits']:.0f}/"
                f"{snap['prefetch_misses']:.0f} "
                f"({100 * snap['prefetch_hit_rate']:.1f}%) "
                f"migrated={snap['migration_bytes'] / 2**20:.1f}MiB "
                f"stalls={snap['stalls']:.0f} "
                f"({snap['stall_time_total'] * 1e3:.0f}ms)"
            )
        return "  ".join(parts)
