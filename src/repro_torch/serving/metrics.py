"""Request-lifecycle metrics (``repro.serving.metrics`` trimmed to what the
port's scheduler and engine call: no trace spans, tiering or failure
counters), plus the sparsity telemetry the engine folds in when it runs
with ``telemetry=True``.

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
            "tpot_mean": _mean(tpots),
            "tpot_p50": _pct(tpots, 0.50),
            "queue_time_mean": _mean(queues),
        }
        if self.sparsity is not None:
            snap.update(self.sparsity.snapshot())
        return snap
