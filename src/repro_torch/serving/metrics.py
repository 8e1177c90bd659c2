"""Request-lifecycle metrics (``repro.serving.metrics`` without trace
spans): per-request timelines, fleet counters, the SLO aggregates, the
failure-domain counters of :mod:`repro_torch.resilience` (always in the
snapshot), the tiering counters of :mod:`repro_torch.memory` (in the
snapshot once a tiered engine has reported residency), plus the sparsity
telemetry the engine folds in when it runs with ``telemetry=True``.

- TTFT  = first-token time - submit time (includes queueing),
- TPOT  = (finish - first token) / (output tokens - 1),
- queue = first admission time - submit time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass
class RequestMetrics:
    req_id: int
    prompt_tokens: int = 0
    output_tokens: int = 0
    slo_class: str = "interactive"
    deadline: Optional[float] = None
    prefix_hit_tokens: int = 0
    preemptions: int = 0
    #: host-tier misses: stalls waiting for page promotion and their time
    #: (tiered KV memory only; see :mod:`repro_torch.memory`).
    stalls: int = 0
    stall_time: float = 0.0
    #: step-fault retries charged against this request's failure budget.
    retries: int = 0
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
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
        """``interactive`` / ``batch`` miss on first-token time, the
        ``deadline`` class on completion time; unfinished requests never
        count as misses."""
        if self.deadline is None:
            return False
        if self.slo_class == "deadline":
            return self.t_finish is not None and self.t_finish > self.deadline
        return (
            self.t_first_token is not None
            and self.t_first_token > self.deadline
        )


def _pct(xs: List[float], q: float) -> float:
    """Nearest-rank percentile; 0.0 for an empty list."""
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
        self.requests: Dict[int, RequestMetrics] = {}
        self.ticks = 0
        self.prefill_tokens_computed = 0
        self.prefix_hit_tokens = 0
        self.decode_tokens = 0
        self.preemptions = 0
        self.prefix_deferrals = 0
        #: optional :class:`~repro_torch.obs.telemetry.SparsityAggregate`;
        #: decode and prefill sparsity counters fold in via
        #: :meth:`on_sparsity` / :meth:`on_prefill_sparsity` and surface in
        #: :meth:`snapshot`.
        self.sparsity = None
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
        # -- failure domains (repro_torch.resilience); always present so
        # the snapshot carries the counters whether or not faults fire --
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

    def on_submit(self, req_id: int, prompt_tokens: int,
                  slo_class: str = "interactive") -> RequestMetrics:
        r = self._req(req_id)
        r.prompt_tokens = prompt_tokens
        r.slo_class = slo_class
        if r.t_submit is None:
            r.t_submit = self.clock()
        return r

    def on_admit(self, req_id: int, prefix_hit_tokens: int = 0):
        r = self._req(req_id)
        if r.t_admit is None:
            r.t_admit = self.clock()
        r.prefix_hit_tokens += prefix_hit_tokens
        self.prefix_hit_tokens += prefix_hit_tokens

    def on_prefix_defer(self, req_id: int):
        self.prefix_deferrals += 1

    def on_prefill(self, n_tokens: int):
        self.prefill_tokens_computed += n_tokens

    def on_first_token(self, req_id: int):
        r = self._req(req_id)
        if r.t_first_token is None:
            r.t_first_token = self.clock()

    def on_decode_token(self, req_id: int):
        self._req(req_id).output_tokens += 1
        self.decode_tokens += 1

    def on_preempt(self, req_id: int):
        self._req(req_id).preemptions += 1
        self.preemptions += 1

    def on_finish(self, req_id: int):
        r = self._req(req_id)
        if r.t_finish is None:
            r.t_finish = self.clock()

    # -- memory tiering events -----------------------------------------------

    def set_residency(self, hbm_pages: int, host_pages: int):
        self.tiering = True
        self.hbm_resident_pages = hbm_pages
        self.host_resident_pages = host_pages

    def on_prefetch_hit(self, n: int = 1):
        self.prefetch_hits += n

    def on_prefetch_miss(self, n: int = 1):
        self.prefetch_misses += n

    def on_prefetch_staged(self, n: int = 1):
        self.prefetch_staged += n

    def on_migration(self, nbytes: int, demote: bool):
        self.migrations += 1
        self.migration_bytes += nbytes

    def on_stall_begin(self, req_id: int):
        r = self._req(req_id)
        r.stalls += 1
        self.stalls += 1
        self._stall_start.setdefault(req_id, self.clock())

    def on_stall_end(self, req_id: int):
        t0 = self._stall_start.pop(req_id, None)
        if t0 is not None:
            self._req(req_id).stall_time += self.clock() - t0

    # -- failure domains (repro_torch.resilience) ----------------------------

    def on_retry(self, req_id: int, reason: str):
        self._req(req_id).retries += 1
        self.retries += 1

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

    def on_degrade(self, rung: str, reason: str):
        self.degradations[rung] = self.degradations.get(rung, 0) + 1

    def on_repromote(self, rung: str):
        self.repromotions += 1

    def on_watchdog(self, idle_ticks: int):
        self.watchdog_fires += 1

    def on_sampler_anomaly(self, n: int = 1):
        self.sampler_anomalies += n

    def on_host_io_error(self, op: str):
        self.host_io_errors += 1

    def on_request_failed(self, req_id: int, reason: str):
        """Failure budget exhausted: terminal, with a structured reason.
        The request is not counted as finished (``t_finish`` stays unset),
        so latency aggregates cover completed requests only."""
        self.requests_failed[req_id] = reason

    # -- device-side sparsity telemetry --------------------------------------

    def on_sparsity(self, tel, slots):
        """Fold one decode tick's ``[n_layers, B, 4]`` counter array (a
        fresh host copy, kept until the next snapshot)."""
        if self.sparsity is not None:
            self.sparsity.update_decode(tel, slots)

    def on_prefill_sparsity(self, attended, candidates=None):
        """Fold one prefill chunk's per-layer attended-block counts."""
        if self.sparsity is not None:
            self.sparsity.update_prefill(attended, candidates)

    def snapshot(self) -> Dict[str, Any]:
        """Aggregate view over finished requests (plus fleet counters)."""
        done = [r for r in self.requests.values() if r.t_finish is not None]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        tpots = [r.tpot for r in done if r.tpot is not None]
        queues = [r.queue_time for r in done if r.queue_time is not None]
        processed = self.prefix_hit_tokens + self.prefill_tokens_computed
        snap = {
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
            "ttft_mean": _mean(ttfts),
            "ttft_p50": _pct(ttfts, 0.50),
            "ttft_p95": _pct(ttfts, 0.95),
            "ttft_p99": _pct(ttfts, 0.99),
            "tpot_mean": _mean(tpots),
            "tpot_p50": _pct(tpots, 0.50),
            "tpot_p95": _pct(tpots, 0.95),
            "tpot_p99": _pct(tpots, 0.99),
            "queue_time_mean": _mean(queues),
        }
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
