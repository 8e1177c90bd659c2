"""Serving scheduler: SLO-aware admission, chunked prefill, preemption.

A copy of ``repro.serving.scheduler``, failure-domain paths included
(checkpoint restore with backoff, failure budgets, forced preemption).
Tiered KV memory (:mod:`repro_torch.memory`) reaches its tier paths: a
:class:`~repro_torch.memory.TieredPagePool` refuses admission past its
``max_live_seqs`` or when its tiers are full, and the ``tier_bound`` branch
of the decode-page reservation (tier exhaustion or an injected
:class:`~repro_torch.resilience.HostIOError`) preempts without trying
prefix-cache eviction.

The :class:`Scheduler` owns the request lifecycle
(``queued -> prefill -> decode -> finished``, with ``preempted`` looping
back to ``queued``) and all policy; the :class:`~repro_torch.serving.engine.Engine`
executes its decisions against the jit'd model steps.  Per tick it emits a
:class:`TickPlan`:

- **admission** — earliest-effective-deadline-first (EDF) over the waiting
  queue into free batch slots, gated by page-pool accounting.  Every
  request carries an SLO class (``interactive`` / ``batch`` / ``deadline``)
  that maps to an *effective deadline* at submit: ``deadline`` requests
  bring their own completion deadline, ``interactive``/``batch`` get
  ``t_submit + ServeConfig.{interactive,batch}_ttft_slo``.  Within one
  class EDF degenerates to FCFS (deadlines grow with submit time), across
  classes urgent traffic outranks throughput traffic.  Prompts are matched
  against the radix prefix cache first: the shared page-aligned prefix is
  ``fork``'d (refcounted, zero prefill compute) and only the divergent
  suffix needs fresh pages (prefix-cache eviction is tried before giving
  up).  A prompt whose prefix is *about* to be published — a sequence
  sharing it is still prefilling — is deferred a bounded number of ticks
  (``ServeConfig.prefix_wait_ticks``) so shared-prefix arrivals group into
  one prefill plus cache hits instead of N parallel prefills.
- **chunked prefill** — a token budget per tick
  (``ServeConfig.prefill_tokens_per_tick``) is spread deadline-first over
  prefilling sequences in ``prefill_chunk``-sized chunks, so a long prompt
  no longer stalls the running decode batch between chunks.
- **preemption** — before each decode tick every decoding sequence gets a
  page reservation for its next token; on exhaustion the running sequence
  with the *farthest effective deadline* is preempted (deadline-aware
  victim selection — never a sequence with a nearer deadline than any
  peer): pages freed, generated output preserved, and the request
  re-queued with its original deadline (its continuation replays on
  re-admission).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cache.paged_kv import PagePool, PoolExhausted
from repro_torch.cache.prefix_cache import PrefixCache
from repro_torch.config import ServeConfig
from repro_torch.serving.metrics import ServingMetrics


#: request SLO classes: ``interactive`` chat traffic (tight TTFT target),
#: ``batch`` throughput traffic (loose TTFT target), ``deadline`` requests
#: carrying an explicit completion deadline (``Request.deadline_s``).
SLO_INTERACTIVE, SLO_BATCH, SLO_DEADLINE = "interactive", "batch", "deadline"
SLO_CLASSES = (SLO_INTERACTIVE, SLO_BATCH, SLO_DEADLINE)


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    prefix_emb: Optional[np.ndarray] = None
    #: SLO class driving admission order and preemption victim selection
    #: (see :data:`SLO_CLASSES`).
    slo_class: str = SLO_INTERACTIVE
    #: completion deadline in clock units relative to submit time; required
    #: for (and only meaningful with) ``slo_class="deadline"``.
    deadline_s: Optional[float] = None
    # filled by the engine:
    output: List[int] = field(default_factory=list)
    done: bool = False
    #: "ok" | "failed" — "failed" when the request exhausted its failure
    #: budget and was retired without completing (see repro_torch.resilience).
    status: str = "ok"
    #: structured failure record (reason / detail / tick / retries).
    failure: Optional[Dict[str, Any]] = None


QUEUED, PREFILL, DECODE, FINISHED = "queued", "prefill", "decode", "finished"
#: terminal state for a request retired by the failure budget.
FAILED = "failed"


@dataclass
class SeqState:
    """Scheduler-side bookkeeping for one request."""

    req: Request
    arrival: int                        # submission order (EDF tie-break)
    state: str = QUEUED
    slot: int = -1
    #: submit timestamp (metrics clock) — fixed across re-admissions.
    t_submit: float = 0.0
    #: absolute effective deadline: ``deadline`` requests carry their own,
    #: ``interactive``/``batch`` get ``t_submit + class TTFT target``.
    #: Admission is earliest-deadline-first; preemption victimizes the
    #: farthest.  Preserved across preemption / restore (a re-queued
    #: request keeps its urgency instead of going to the back of the line).
    deadline: float = float("inf")
    #: ticks this admission has been deferred waiting for a shared prefix
    #: still being prefilled by a peer (bounded by
    #: ``ServeConfig.prefix_wait_ticks``).
    prefix_deferred: int = 0
    #: the token span to prefill this admission: the prompt, extended with
    #: already-generated output after a preemption (recompute-style resume).
    prefill_tokens: np.ndarray = None   # type: ignore[assignment]
    #: tokens of ``prefill_tokens`` whose KV is in the cache slot.
    prefilled: int = 0
    #: prefix-cache tokens installed at this admission (skipped compute).
    prefix_tokens: int = 0
    #: committed output tokens to replay through the DECODE path after a
    #: resume (preemption or failure-domain restore): fed as forced inputs
    #: one per tick, samples discarded, so the regenerated KV is
    #: byte-identical to the original decode-time KV.  Recomputing them via
    #: chunked prefill instead is NOT exact when sparse decode is active —
    #: dense prefill and sparse decode see different hidden states for the
    #: same token, and the drift can flip later samples.
    replay: List[int] = field(default_factory=list)
    #: last checkpoint (:class:`repro_torch.resilience.Checkpoint`) — the
    #: committed-output watermark a failure-domain restore truncates to.
    checkpoint: Optional[Any] = None
    #: step-fault retries consumed (counts toward the failure budget).
    retries: int = 0
    #: earliest tick this sequence may be re-admitted after a restore
    #: (exponential backoff); admission skips it without blocking peers.
    retry_after: int = 0

    def __post_init__(self):
        if self.prefill_tokens is None:
            self.prefill_tokens = np.asarray(self.req.prompt, np.int32)

    @property
    def seq_id(self) -> int:
        return self.req.req_id

    @property
    def n_prefill(self) -> int:
        return len(self.prefill_tokens)

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= self.n_prefill


@dataclass
class AdmitDecision:
    seq: SeqState
    slot: int
    prefix_tokens: int                  # page-aligned prefix-cache hit span
    prefix_kv: List[Any]                # KV snapshots, one per page


@dataclass
class ChunkPlan:
    seq: SeqState
    offset: int                         # absolute position of tokens[0]
    tokens: np.ndarray                  # [n] the chunk (unpadded)
    is_last: bool                       # prefill completes with this chunk


@dataclass
class TickPlan:
    admitted: List[AdmitDecision]
    chunks: List[ChunkPlan]


class Scheduler:
    def __init__(
        self,
        serve: ServeConfig,
        pool: PagePool,
        prefix_cache: Optional[PrefixCache],
        metrics: ServingMetrics,
        chunkable: bool = True,
        chunk_align: int = 1,
    ):
        self.serve = serve
        self.pool = pool
        self.prefix_cache = prefix_cache
        self.metrics = metrics
        #: model supports incremental (chunked) prefill into a batch slot;
        #: without it prompts prefill monolithically and prefix reuse is off.
        self.chunkable = chunkable
        #: chunk boundaries (interior chunk ends + reused prefix spans) are
        #: rounded down to this many tokens.  Sparse prefill sets it to the
        #: query-block size so chunked selection is token-identical to
        #: single-shot; 1 == no constraint.
        assert chunk_align >= 1
        if chunk_align > 1:
            assert serve.prefill_chunk == 0 or (
                chunk_align <= serve.prefill_chunk
            ), (chunk_align, serve.prefill_chunk)
            # prefix spans are page-granular; alignment rounding must land
            # on page boundaries too.
            assert chunk_align % pool.page_size == 0, (
                chunk_align, pool.page_size
            )
        self.chunk_align = chunk_align
        self.waiting: List[SeqState] = []
        self.running: Dict[int, SeqState] = {}
        self._arrival = itertools.count()

    # -- intake --------------------------------------------------------------

    def submit(self, req: Request) -> SeqState:
        worst = self.pool.pages_for(len(req.prompt) + req.max_new_tokens)
        if worst > self.pool.total_pages:
            raise ValueError(
                f"request {req.req_id} can never fit: needs {worst} pages, "
                f"pool has {self.pool.total_pages}"
            )
        if req.slo_class not in SLO_CLASSES:
            raise ValueError(
                f"request {req.req_id}: unknown SLO class {req.slo_class!r} "
                f"(one of {SLO_CLASSES})"
            )
        if req.slo_class == SLO_DEADLINE and (
            req.deadline_s is None or req.deadline_s <= 0
        ):
            raise ValueError(
                f"request {req.req_id}: slo_class='deadline' requires a "
                f"positive deadline_s, got {req.deadline_s!r}"
            )
        seq = SeqState(req, next(self._arrival))
        rm = self.metrics.on_submit(
            req.req_id, len(req.prompt), slo_class=req.slo_class
        )
        seq.t_submit = rm.t_submit
        if req.slo_class == SLO_DEADLINE:
            seq.deadline = seq.t_submit + req.deadline_s
        else:
            seq.deadline = seq.t_submit + self.serve.slo_target(req.slo_class)
        rm.deadline = seq.deadline
        self._enqueue(seq)
        return seq

    @staticmethod
    def _edf_key(seq: SeqState):
        """Waiting-queue order: earliest effective deadline first, arrival
        as the deterministic tie-break (within one SLO class this is FCFS,
        since deadlines grow monotonically with submit time)."""
        return (seq.deadline, seq.arrival)

    def _enqueue(self, seq: SeqState):
        """Insert into the waiting queue at its EDF position."""
        key = self._edf_key(seq)
        i = 0
        while i < len(self.waiting) and self._edf_key(self.waiting[i]) <= key:
            i += 1
        self.waiting.insert(i, seq)

    def _requeue(self, seq: SeqState):
        """Re-insert a preempted/restored sequence.  Its original deadline
        is preserved, so EDF puts it back ahead of later, less-urgent
        arrivals instead of at the back of the line."""
        self._enqueue(seq)

    def _seq_chunkable(self, seq: SeqState) -> bool:
        return self.chunkable and seq.req.prefix_emb is None

    # -- per-tick planning ---------------------------------------------------

    def plan_tick(self, free_slots: Sequence[int]) -> TickPlan:
        return TickPlan(self._admit(list(free_slots)), self._plan_chunks())

    def _shared_prefix_pages(self, a: np.ndarray, b: np.ndarray) -> int:
        """Leading whole pages on which prompts ``a`` and ``b`` agree."""
        ps = self.pool.page_size
        n = min(len(a), len(b)) // ps
        shared = 0
        for i in range(n):
            if not np.array_equal(a[i * ps:(i + 1) * ps],
                                  b[i * ps:(i + 1) * ps]):
                break
            shared += 1
        return shared

    def _pending_prefix_tokens(self, seq: SeqState) -> int:
        """Longest page-aligned prefix of ``seq``'s prompt currently being
        prefilled by a running peer — i.e. the span the radix cache will
        serve once that peer completes and publishes its prompt pages."""
        best = 0
        for peer in self.running.values():
            if peer.state != PREFILL or not self._seq_chunkable(peer):
                continue
            best = max(best, self._shared_prefix_pages(
                seq.prefill_tokens, peer.prefill_tokens
            ))
        return best * self.pool.page_size

    def _admit(self, free_slots: List[int]) -> List[AdmitDecision]:
        out: List[AdmitDecision] = []
        idx = 0
        while idx < len(self.waiting) and free_slots:
            seq = self.waiting[idx]
            if seq.retry_after > self.metrics.ticks:
                # restore backoff: not eligible yet — skip it instead of
                # head-of-line blocking the queue behind a failing request.
                idx += 1
                continue
            tokens = seq.prefill_tokens
            matched, pages, kvs = 0, [], []
            if self.prefix_cache is not None and self._seq_chunkable(seq):
                # leave >= 1 suffix token so prefill produces logits for
                # the first sampled token.
                matched, pages, kvs = self.prefix_cache.match(
                    tokens, max_tokens=len(tokens) - 1
                )
                if self.chunk_align > 1 and matched % self.chunk_align:
                    # reused spans must end on a chunk-alignment boundary so
                    # the first fresh chunk starts query-block aligned.
                    matched = (matched // self.chunk_align) * self.chunk_align
                    keep = matched // self.pool.page_size
                    pages, kvs = pages[:keep], kvs[:keep]
                # prefix-cache-aware grouping: a peer is prefilling a
                # longer shared prefix than the cache can serve right now —
                # defer (bounded) so this request admits against the
                # published pages instead of recomputing them in parallel.
                if (
                    self.serve.prefix_wait_ticks > 0
                    and seq.prefix_deferred < self.serve.prefix_wait_ticks
                    and self._pending_prefix_tokens(seq) > matched
                ):
                    seq.prefix_deferred += 1
                    self.metrics.on_prefix_defer(seq.seq_id)
                    idx += 1
                    continue
            need_fresh = self.pool.pages_for(len(tokens)) - len(pages)
            if need_fresh > self.pool.free_pages:
                ok = self.prefix_cache is not None and (
                    self.prefix_cache.evict_for(need_fresh, protect=pages)
                )
                if not ok:
                    break  # FCFS head-of-line admission control
            try:
                self.pool.fork(seq.seq_id, pages, len(tokens))
            except PoolExhausted:
                # tiered pools can refuse beyond the free-page check: the
                # HBM budget may be fully covered by protected working sets
                # or the host spill tier may be full.  Head-of-line block;
                # decode progress (or retirement) frees tier room.
                break
            self.waiting.pop(idx)
            seq.state = PREFILL
            seq.slot = free_slots.pop(0)
            seq.prefilled = matched
            seq.prefix_tokens = matched
            self.running[seq.seq_id] = seq
            self.metrics.on_admit(seq.seq_id, matched)
            out.append(AdmitDecision(seq, seq.slot, matched, kvs))
        return out

    def _plan_chunks(self) -> List[ChunkPlan]:
        budget = self.serve.prefill_tokens_per_tick
        chunks: List[ChunkPlan] = []
        prefilling = sorted(
            (s for s in self.running.values() if s.state == PREFILL),
            key=self._edf_key,
        )
        for seq in prefilling:
            if not self._seq_chunkable(seq):
                # monolithic fallback: the whole remaining prompt as one
                # chunk (still budget-charged so it throttles later peers).
                if budget <= 0:
                    break
                n = seq.n_prefill - seq.prefilled
                chunks.append(ChunkPlan(
                    seq, seq.prefilled,
                    seq.prefill_tokens[seq.prefilled:], True,
                ))
                seq.prefilled = seq.n_prefill
                budget -= n
                continue
            while budget > 0 and not seq.prefill_done:
                remaining = seq.n_prefill - seq.prefilled
                n = min(self.serve.prefill_chunk, remaining, budget)
                if self.chunk_align > 1 and n < remaining:
                    # interior chunk: end on an alignment boundary (chunk
                    # offsets stay aligned by induction; only the final
                    # chunk may be ragged).  When the leftover budget
                    # rounds to zero, spend one alignment unit anyway so
                    # a tick always makes progress.
                    n = (n // self.chunk_align) * self.chunk_align
                    if n == 0:
                        n = min(self.chunk_align, remaining)
                chunks.append(ChunkPlan(
                    seq, seq.prefilled,
                    seq.prefill_tokens[seq.prefilled : seq.prefilled + n],
                    seq.prefilled + n >= seq.n_prefill,
                ))
                seq.prefilled += n
                budget -= n
            if budget <= 0:
                break
        return chunks

    # -- decode capacity / preemption ----------------------------------------

    def choose_victim(self, candidates) -> SeqState:
        """Deadline-aware victim selection: among ``candidates`` (an
        iterable of running SeqStates) pick the FARTHEST effective
        deadline, latest arrival as the tie-break.  The invariant the SLO
        property tests assert: the victim never has a strictly nearer
        deadline than any other candidate."""
        return max(candidates, key=lambda s: (s.deadline, s.arrival))

    def prepare_decode(self, decode: Sequence[SeqState]) -> List[SeqState]:
        """Reserve one more token of page capacity for every decoding
        sequence (nearest deadline first); preempt the farthest-deadline
        running sequence on exhaustion.
        -> the preempted sequences (engine must clear their slots)."""
        preempted: List[SeqState] = []
        for seq in sorted(decode, key=self._edf_key):
            if seq.state != DECODE:      # preempted by an earlier iteration
                continue
            while True:
                try:
                    self.pool.extend(seq.seq_id, 1)
                    break
                except PoolExhausted as exc:
                    # tier-bound exhaustion (tiered pool: HBM shield or
                    # host tier full, or an injected ``HostIOError``)
                    # cannot be fixed by unpinning cached pages —
                    # ``evict_for`` would report success off the free-page
                    # count without freeing any tier room and this loop
                    # would spin; go straight to preemption.
                    if not getattr(exc, "tier_bound", False) and (
                        self.prefix_cache is not None
                        and self.prefix_cache.evict_for(1)
                    ):
                        continue
                    victim = self.choose_victim(self.running.values())
                    self._preempt(victim)
                    preempted.append(victim)
                    if victim is seq:
                        break
        return preempted

    def preempt(self, seq: SeqState):
        """Forced preemption — the tiered-memory starvation breaker calls
        this for a sequence whose host-tier miss could not be promoted for
        consecutive ticks (every resident page shielded by other sequences'
        working sets), and the watchdog for its victim when ticks stop
        making progress; freeing its table is the way to restore
        progress."""
        self._preempt(seq)

    def _preempt(self, seq: SeqState):
        self._release(seq)
        self.metrics.on_preempt(seq.seq_id)

    def _release(self, seq: SeqState):
        """Free the sequence's pages and re-queue it with its generated
        output preserved (shared with preemption and the failure-domain
        restore).  Only the PROMPT re-prefills on resume (and typically
        re-matches the prefix cache, whose snapshots are the original
        bytes); the committed output replays through the decode path —
        see ``SeqState.replay`` for why prefill recompute would not be
        byte-exact."""
        self.pool.free(seq.seq_id)
        del self.running[seq.seq_id]
        seq.prefill_tokens = np.asarray(seq.req.prompt, np.int32)
        seq.replay = list(seq.req.output)
        seq.state = QUEUED
        seq.prefilled = 0
        seq.prefix_tokens = 0
        seq.prefix_deferred = 0
        self._requeue(seq)

    # -- failure domains (repro_torch.resilience) ----------------------------

    def restore(self, seq: SeqState, eligible_tick: int = 0):
        """Failure-domain restore: truncate the output to the last
        checkpoint's watermark and re-queue the request, not eligible for
        re-admission before ``eligible_tick`` (exponential backoff).  The
        truncated tokens regenerate byte-identically on re-admission —
        sampling is keyed by (seq_id, position), and the resume prefill
        rebuilds KV exactly."""
        ck = seq.checkpoint
        out = seq.req.output
        if ck is not None and len(out) > ck.n_output:
            del out[ck.n_output:]
        seq.retry_after = eligible_tick
        self._release(seq)
        self.metrics.on_restore(seq.seq_id)

    def fail(self, seq: SeqState, reason: str):
        """Retire a request as FAILED (failure budget exhausted): free its
        pages and drop it from the running set with a structured reason —
        the tick loop keeps serving everyone else."""
        self.pool.free(seq.seq_id)
        self.running.pop(seq.seq_id, None)
        if seq in self.waiting:
            self.waiting.remove(seq)
        seq.state = FAILED
        self.metrics.on_request_failed(seq.seq_id, reason)

    # -- retirement ----------------------------------------------------------

    def retire(self, seq: SeqState):
        self.pool.free(seq.seq_id)
        del self.running[seq.seq_id]
        seq.state = FINISHED
        self.metrics.on_finish(seq.seq_id)

    # -- introspection -------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
