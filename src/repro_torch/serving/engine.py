"""Continuous-batching serving engine, single device (counterpart of
``repro.serving.engine``).

Per tick the engine executes what the
:class:`~repro_torch.serving.scheduler.Scheduler` decides:

1. **admit** waiting requests into free slots (page-pool gated); a prompt
   whose page-aligned prefix hits the radix prefix cache gets the cached KV
   pages copied into its slot and its score segment rebuilt;
2. **prefill chunks** through ``Transformer.prefill_chunk`` (dense, or
   query-block sparse under ``SparseConfig.sparse_prefill``); a finished
   prompt gets its decode store rebuilt and its pages published to the
   prefix cache.  With ``ServeConfig.prefill_chunk`` 0 a prompt is
   prefilled in one ``Transformer.prefill`` at ``max_context`` and
   scattered into its slot, and there is no prefix cache;
3. **decode** one ``decode_step`` over the whole batch; only decoding slots
   consume the sampled tokens (host-side lengths are authoritative);
4. **retire / preempt** finished or evicted sequences.

With ``telemetry=True`` (and the plan active at ``max_context``) the
decode step and each sparse prefill chunk also fill the sparsity counters
of :mod:`repro_torch.obs.telemetry`, which the engine copies to the host
once per decode tick and once per chunk and folds into
``metrics.snapshot()``.

Failure domains (:mod:`repro_torch.resilience`, policy in
``ServeConfig.resilience``), as in the JAX engine:

- a **degradation ladder**: on ``"cuda"`` the rungs are fused -> staged ->
  reference (the plain versions, dense prefill), each a view of the same
  model under another ``SparseConfig`` (:meth:`Transformer.with_sparse`),
  over the same cache.  A step fault re-runs the chunk or the decode step
  one rung down within the tick; the rung sticks and re-promotes after
  ``repromote_after`` clean decode ticks.  Every rung change is counted
  (``metrics.degradations_by_rung``, ``repromotions``).  Only an injected
  fault moves the ladder: an :class:`InjectedDeviceError`, or a
  :class:`SamplerAnomaly` whose non-finite rows the injector poisoned.  A
  real non-finite row or ``FloatingPointError`` is charged to the
  implicated sequences' failure budgets on the rung it happened on, so a
  kernel's bad output never moves serving onto the plain versions.  A
  real CUDA error (a kernel's build or launch, an asynchronous fault)
  propagates, since the context it leaves cannot be trusted and a
  degraded re-run would hide a broken kernel;
- at the ladder's floor (or for a real fault), **per-sequence
  checkpoints**: the implicated
  sequences restore from their committed-output watermark behind an
  exponential backoff, and retire as FAILED with a structured reason once
  their failure budget is spent; the healthy rows of a decode step commit;
- a **tick watchdog**: ``watchdog_ticks`` ticks without progress (with
  work pending) preempt the scheduler's victim;
- fault injection (``set_fault_injector``) at the decode and prefill
  dispatch, the page pool's allocator and the tick clock.

The port's cache is updated in place (JAX donates and replaces it).  A
re-run is still safe: every decode attempt first copies the host-side
lengths into ``cache["seq_len"]``, and a decode step or chunk rewrites the
same KV rows and re-derives the same store rows from them, so a degraded
re-run leaves the bytes a clean run on that rung leaves.  The same
idempotence lets each kernel rung's decode step be captured once over the
live cache as a CUDA graph and replayed every tick
(:mod:`repro_torch.serving.graphs`, the counterpart of JAX's jitted,
cache-donating step; ``step_graphs_disabled()`` builds eager engines).

Tiered KV memory (:mod:`repro_torch.memory`, ``ServeConfig.hbm_pages`` /
``host_pages``), as in the JAX engine: the page pool is a
:class:`~repro_torch.memory.TieredPagePool` whose cold pages are demoted to
pinned host memory (their device rows poisoned in place) and promoted back
by the :class:`~repro_torch.memory.MemoryManager`.  The decode step then
also emits each slot's selected and margin-predicted pages
(``cache["_sel_pages"]`` / ``["_pre_pages"]``); a sequence whose selection
touched a page that was host-resident at launch discards its token and
stalls until the page is back, and its step re-runs (the rest of the batch
commits).  The device cache keeps its full size: the budget is accounting,
as in JAX.

Not ported (each raises ``NotImplementedError`` when asked for): a device
mesh and tracing.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cache.paged_kv import PagePool
from repro_torch.cache.prefix_cache import PrefixCache
from repro_torch.config import ModelConfig, ServeConfig
from repro_torch.memory import MemoryManager, TieredPagePool
from repro_torch.models import Transformer, resolve_device
from repro_torch.obs.telemetry import (
    N_COUNTERS,
    SparsityAggregate,
    prefill_block_candidates,
)
from repro_torch.resilience import (
    DEVICE_FAULTS,
    FAIL_DEVICE,
    FAIL_SAMPLER,
    Checkpoint,
    FailureInfo,
    FaultInjector,
    InjectedFault,
)
from repro_torch.serving import graphs
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.sampler import SamplerAnomaly, finite_mask, sample
from repro_torch.serving.scheduler import (
    DECODE,
    PREFILL,
    AdmitDecision,
    ChunkPlan,
    Request,
    Scheduler,
    SeqState,
)


class EngineStalled(RuntimeError):
    """``run_until_done`` exhausted its tick budget with work still queued.

    Carries a post-mortem: ``diagnostics`` (queue depths, per-sequence
    phase / slot / retry state, pool occupancy, ladder rung, the last
    metrics snapshot) and ``retired``, the requests that did complete
    during the call."""

    def __init__(self, message: str, diagnostics: Optional[Dict] = None,
                 retired: Optional[List[Request]] = None):
        super().__init__(message)
        self.diagnostics = diagnostics or {}
        self.retired = list(retired or [])


#: step faults the engine catches: injected device errors,
#: ``FloatingPointError`` and non-finite sampler input.  Anything else (a
#: real CUDA error among them) propagates.
_STEP_FAULTS = DEVICE_FAULTS + (SamplerAnomaly,)


def _injected(exc: BaseException) -> bool:
    """Whether a step fault came from the fault injector: only those move
    the degradation ladder."""
    return isinstance(exc, InjectedFault) or (
        isinstance(exc, SamplerAnomaly) and exc.injected)


def _fault_reason(exc: BaseException) -> str:
    return FAIL_SAMPLER if isinstance(exc, SamplerAnomaly) else FAIL_DEVICE


class Engine:
    def __init__(
        self,
        model_cfg: ModelConfig,
        model: Transformer,
        serve_cfg: ServeConfig,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
        device="cuda",
        mesh=None,
        trace=None,
        fault_injector: Optional[FaultInjector] = None,
        telemetry: bool = False,
    ):
        """``model`` holds the weights (a :class:`Transformer` on
        ``device``); batch capacity and context length come from
        ``serve_cfg``.  ``telemetry`` turns on the sparsity counters;
        ``fault_injector`` is attached as by :meth:`set_fault_injector`."""
        for name, val in (("mesh", mesh), ("trace", trace)):
            if val is not None:
                raise NotImplementedError(f"{name} is not ported")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        self.cfg = model_cfg
        self.serve = serve_cfg
        self.model = model
        self.seed = seed
        if serve_cfg.hbm_pages is not None:
            self.pool: PagePool = self._tiered_pool(model_cfg, model, serve_cfg)
        else:
            self.pool = PagePool(
                total_pages=serve_cfg.pool_pages
                or self.max_batch * (self.max_context // serve_cfg.page_size),
                page_size=serve_cfg.page_size,
            )
        self.cache = model.init_cache(self.max_batch, self.max_context)
        self.slots: List[Optional[SeqState]] = [None] * self.max_batch
        self.finished: List[Request] = []
        self.metrics = ServingMetrics(clock=clock)
        self.memory: Optional[MemoryManager] = None
        if isinstance(self.pool, TieredPagePool):
            # every decode step reports the per-slot selected and
            # margin-predicted page masks into these
            nP = self.max_context // serve_cfg.page_size
            for key in ("_sel_pages", "_pre_pages"):
                self.cache[key] = torch.zeros((self.max_batch, nP),
                                              dtype=torch.bool, device=self.device)
            self.memory = MemoryManager(self, self.pool)
        self._chunk_len = min(serve_cfg.prefill_chunk, self.max_context)
        self._chunkable = serve_cfg.prefill_chunk > 0
        self.prefix_cache = (
            PrefixCache(self.pool)
            if serve_cfg.enable_prefix_cache and self._chunkable else None
        )
        #: sparse prefill runs: chunk boundaries and reused prefix spans then
        #: align to the query-block size (chunked selection is then
        #: token-identical to single-shot sparse prefill)
        self._sparse_prefill = (model_cfg.sparse.sparse_prefill
                                and self._chunkable
                                and model.use_sparse(self.max_context))
        self.scheduler = Scheduler(
            serve_cfg, self.pool, self.prefix_cache, self.metrics,
            chunkable=self._chunkable,
            chunk_align=(model_cfg.sparse.prefill_block_q
                         if self._sparse_prefill else 1),
        )
        self._tokens_buf = np.zeros((self.max_batch,), np.int64)
        #: authoritative per-slot sequence lengths (tokens with KV in cache).
        self._seq_len = np.zeros((self.max_batch,), np.int32)
        # counters only where selection runs (as JAX's set_tracing)
        self._telemetry_on = telemetry and model.use_sparse(self.max_context)
        if self._telemetry_on:
            L = model_cfg.n_layers
            self.cache["_telemetry"] = torch.zeros(
                (L, self.max_batch, N_COUNTERS), dtype=torch.int32,
                device=self.device)
            if self._sparse_prefill:
                self.cache["_ptel"] = torch.zeros((L,), dtype=torch.int32,
                                                  device=self.device)
            self.metrics.sparsity = SparsityAggregate(L)
            self._plan_layouts = model.attention_plan(self.max_context).layouts
        # -- failure domains (repro_torch.resilience) ------------------------
        self.resilience = serve_cfg.resilience
        #: optional FaultInjector; None keeps every injection point a
        #: single attribute check.
        self._fault: Optional[FaultInjector] = None
        #: degradation ladder: rung 0 is the configured backend; the rungs'
        #: model views are built lazily (``_rung_step_fns``).
        self._ladder = self._build_ladder()
        self._rung_models: Dict[int, Transformer] = {0: model}
        #: rung -> its captured decode step (``_rung_step_fns``); on CUDA
        #: only, and not for engines built under ``step_graphs_disabled()``
        self._step_graphs: Dict[int, graphs.DecodeGraph] = {}
        self._graph_pool = None
        self._graphed = (graphs.graph_device(self.device)
                         and graphs.step_graphs_enabled())
        self._rung = 0              # current (sticky) operating rung
        self._clean_ticks = 0       # clean decode ticks since a degradation
        self._tick_had_fault = False
        self._idle_ticks = 0        # consecutive no-progress ticks (watchdog)
        if fault_injector is not None:
            self.set_fault_injector(fault_injector)

    def _tiered_pool(self, model_cfg: ModelConfig, model: Transformer,
                     serve_cfg: ServeConfig) -> TieredPagePool:
        """Tiered KV memory's pool: ``hbm_pages`` on the device, ``host_pages``
        spilled to the host, and the admission cap ``max_live_seqs``."""
        if serve_cfg.pool_pages is not None:
            raise ValueError(
                "hbm_pages and pool_pages are mutually exclusive: the "
                "tiered pool's capacity is hbm_pages + host_pages"
            )
        if not model.use_sparse(self.max_context):
            raise ValueError(
                "tiered KV memory requires the sparse decode path to be "
                f"active at max_context={self.max_context}: dense decode "
                "reads every KV row, so host-resident pages would corrupt it"
            )
        if model_cfg.layer_pattern != ("attn",):
            raise ValueError(
                "tiered KV memory needs idempotent decode steps (a host-tier "
                "miss re-runs the owning sequence's step): layer pattern "
                f"{model_cfg.layer_pattern} carries cross-step state"
            )
        pool = TieredPagePool(hbm_pages=serve_cfg.hbm_pages,
                              host_pages=serve_cfg.host_pages,
                              page_size=serve_cfg.page_size)
        # admission cap: each decoding sequence shields its selected pages
        # + tail page + next-token reservation, estimated as one head's
        # selection (the union over layers and heads the shield really
        # holds can be the whole context).  Past hbm_pages // ws concurrent
        # sequences the combined shields can cover the whole budget,
        # leaving no demotion victim for anyone (a livelock preemption only
        # breaks after the fact); refuse the admission up front instead.
        ws_est = (model_cfg.sparse.budget_for(self.max_context)
                  // serve_cfg.page_size + 2)
        pool.max_live_seqs = max(1, serve_cfg.hbm_pages // ws_est)
        return pool

    @property
    def max_batch(self) -> int:
        return self.serve.max_batch

    @property
    def max_context(self) -> int:
        return self.serve.max_context

    # -- fault injection / degradation ladder (repro_torch.resilience) -------

    def set_fault_injector(self, injector: Optional[FaultInjector]):
        """Attach/detach a :class:`~repro_torch.resilience.FaultInjector` on
        a live engine.  It threads through the page pool's allocator, the
        memory manager's host-tier I/O, the decode / prefill dispatch and
        the tick clock; with ``None`` every one of those points is a single
        ``is not None`` check."""
        self._fault = injector
        self.pool.fault_hook = None if injector is None else self._pool_fault
        if self.memory is not None:
            self.memory.fault = injector

    def _pool_fault(self, reason: str, need: int):
        self._fault.check_raise(
            "pool_alloc", tick=self.metrics.ticks, detail=f"{reason} x{need}"
        )

    def _build_ladder(self) -> List[Tuple[str, Optional[Dict]]]:
        """Rungs of ``(name, sparse-config overrides)``; ``None`` = the
        configured backend as-is.  The reference rung runs the plain
        versions (no kernel) with dense prefill: the oracle every kernel is
        held against, so the safe floor."""
        sp = self.cfg.sparse
        ref = {"backend": "reference", "fused_decode": False,
               "sparse_prefill": False}
        if sp.backend == "cuda" and sp.fused_decode:
            return [("fused", None), ("staged", {"fused_decode": False}),
                    ("reference", ref)]
        if sp.backend == "cuda":
            return [("staged", None), ("reference", ref)]
        return [(sp.backend, None)]

    def _rung_step_fns(self, rung: int) -> Tuple[Callable, Callable]:
        """(decode_step, prefill_chunk) of ``rung``'s model view, built
        lazily.  Every rung shares the engine's weights and cache: the
        paged KV and store layout is the same on every backend (their
        stores are byte-identical), so a degraded re-run reads the device
        state the failed attempt would have read.

        On CUDA the decode step of a rung whose backend launches kernels
        is a :class:`~repro_torch.serving.graphs.DecodeGraph` over the
        engine's cache, captured at its first call (as JAX jits each rung's
        step lazily); the graphs share one memory pool.  The plain
        ``"reference"`` rung, the floor every kernel is held against, stays
        eager, and so does every prefill chunk."""
        if rung not in self._rung_models:
            self._rung_models[rung] = self.model.with_sparse(
                **self._ladder[rung][1])
        m = self._rung_models[rung]
        if not self._graphed or m.backend.plain:
            return m.decode_step, m.prefill_chunk
        if rung not in self._step_graphs:
            if self._graph_pool is None:
                self._graph_pool = graphs.new_pool()
            self._step_graphs[rung] = graphs.DecodeGraph(
                m.decode_step, self.cache, self._graph_pool)
        return self._step_graphs[rung], m.prefill_chunk

    def _with_ladder(self, seqs_of, attempt) -> bool:
        """Run ``attempt(rung)`` under the degradation ladder: a step fault
        re-runs the attempt at the next rung down within the same tick.
        Success at a degraded rung makes that rung sticky (re-promotion
        after ``resilience.repromote_after`` clean ticks).  At the floor,
        and for a fault the injector did not cause on any rung, the fault
        is charged to ``seqs_of(exc)`` — each implicated sequence restores
        from its last checkpoint or, past its failure budget, retires as
        FAILED.  -> True when the attempt ran to completion."""
        rung = self._rung
        while True:
            try:
                attempt(rung)
            except _STEP_FAULTS as exc:
                self._tick_had_fault = True
                if _injected(exc) and rung + 1 < len(self._ladder):
                    rung += 1
                    self.metrics.on_degrade(
                        self._ladder[rung][0], _fault_reason(exc)
                    )
                    continue
                self._on_step_failure(seqs_of(exc), exc)
                return False
            break
        if rung != self._rung:
            self._rung = rung
            self._clean_ticks = 0
        return True

    def _on_step_failure(self, seqs: List[SeqState], exc: BaseException):
        """Ladder floor: charge the fault to each implicated sequence's
        failure budget — restore from checkpoint with exponential backoff,
        or retire as FAILED once the budget is spent."""
        reason = _fault_reason(exc)
        for seq in list(seqs):
            if self.scheduler.running.get(seq.seq_id) is not seq:
                continue
            seq.retries += 1
            self.metrics.on_retry(seq.seq_id, reason)
            if seq.retries > self.resilience.failure_budget:
                self._fail_seq(seq, reason, exc)
            else:
                self._restore_seq(seq)

    def _free_slot(self, seq: SeqState):
        """``seq`` left the running set (retired, preempted, restored or
        failed): release its slot and its memory-manager state."""
        if self.memory is not None:
            self.memory.forget(seq.seq_id)
        if seq.slot >= 0:
            self.slots[seq.slot] = None
            self._seq_len[seq.slot] = 0
        seq.slot = -1

    def _restore_seq(self, seq: SeqState):
        """Re-admit ``seq`` from its last checkpoint: output truncated to
        the watermark, pages freed, re-queued behind an exponential
        backoff.  Sampling is keyed by (seq_id, position) and the resume
        rebuilds the KV, so the truncated tokens come back the same."""
        backoff = self.resilience.retry_backoff_ticks * (
            2 ** max(0, seq.retries - 1)
        )
        self.scheduler.restore(seq, self.metrics.ticks + backoff)
        self._free_slot(seq)

    def _fail_seq(self, seq: SeqState, reason: str, exc: BaseException):
        """Failure budget exhausted: retire as FAILED with a structured
        reason instead of poisoning the tick loop."""
        self.scheduler.fail(seq, reason)
        self._free_slot(seq)
        req = seq.req
        req.done = True
        req.status = "failed"
        req.failure = FailureInfo(
            reason=reason, detail=str(exc),
            tick=self.metrics.ticks, retries=seq.retries,
        ).as_dict()
        self.finished.append(req)

    def _take_checkpoint(self, seq: SeqState):
        """O(1) restore point: the committed-output watermark is all a
        restore needs (see :mod:`repro_torch.resilience.failure`)."""
        seq.checkpoint = Checkpoint(
            n_output=len(seq.req.output),
            n_pages=len(self.pool.table(seq.seq_id).physical),
            tick=self.metrics.ticks,
        )
        self.metrics.on_checkpoint(seq.seq_id)

    def diagnostics(self) -> Dict:
        """Post-mortem state dump (attached to :class:`EngineStalled`,
        callable any time): queue depths, per-sequence phase / slot /
        retries / tier residency, pool occupancy, ladder rung, metrics
        snapshot."""
        seqs = {}
        for sid, seq in self.scheduler.running.items():
            d = {
                "phase": seq.state,
                "slot": seq.slot,
                "prefilled": int(seq.prefilled),
                "output_tokens": len(seq.req.output),
                "retries": seq.retries,
            }
            if self.memory is not None:
                d["stalled"] = sid in self.memory.stalled
                d["host_resident_pages"] = len(
                    self.pool.host_resident_logical(sid))
            seqs[sid] = d
        diag = {
            "tick": self.metrics.ticks,
            "waiting": len(self.scheduler.waiting),
            "running": len(self.scheduler.running),
            "in_backoff": [
                [s.seq_id, s.retry_after]
                for s in self.scheduler.waiting
                if s.retry_after > self.metrics.ticks
            ],
            "rung": self._ladder[self._rung][0],
            "idle_ticks": self._idle_ticks,
            "pool": {
                "used_pages": self.pool.used_pages,
                "free_pages": self.pool.free_pages,
            },
            "sequences": seqs,
            "last_snapshot": self.metrics.snapshot(),
        }
        if self._fault is not None:
            diag["faults_injected"] = self._fault.snapshot()
        return diag

    # -- sampling -------------------------------------------------------------

    def _sample(self, seq_ids, positions, logits):
        """-> (tokens, finite mask) as numpy, one per row.  Only the finite
        rows are sampled (``torch.multinomial`` raises on a NaN row); a
        non-finite row's token is 0 and is never committed."""
        fin = finite_mask(logits).cpu().numpy()
        ok = np.flatnonzero(fin)
        toks = np.zeros((len(fin),), np.int64)
        if len(ok):
            rows = logits if len(ok) == len(fin) else logits[
                torch.from_numpy(ok).to(logits.device)]
            toks[ok] = sample(
                rows, [seq_ids[i] for i in ok], [positions[i] for i in ok],
                self.serve.temperature, self.serve.top_k, self.serve.top_p,
                seed=self.seed,
            ).cpu().numpy()
        return toks, fin

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request):
        if len(req.prompt) + req.max_new_tokens > self.max_context:
            raise ValueError(
                f"request {req.req_id}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new tokens exceeds max_context "
                f"{self.max_context}"
            )
        self.scheduler.submit(req)

    def _install(self, adm: AdmitDecision):
        """Occupy the slot, cleared to a fresh cache's rows (no stale rows
        nor poison of an earlier occupant reach its store); copy prefix-cache
        KV pages into its rows and, under sparse prefill, rebuild its score
        segment (the installed span never ran a chunk)."""
        seq = adm.seq
        self.model.clear_slot(self.cache, adm.slot)
        self.slots[adm.slot] = seq
        self._seq_len[adm.slot] = adm.prefix_tokens
        self._tokens_buf[adm.slot] = 0
        if adm.prefix_tokens:
            nP = adm.prefix_tokens // self.serve.page_size
            for l, e in enumerate(self.cache["layers"]):
                e["k"][adm.slot, :, :nP] = torch.stack(
                    [kv["k"][l] for kv in adm.prefix_kv], dim=1)
                e["v"][adm.slot, :, :nP] = torch.stack(
                    [kv["v"][l] for kv in adm.prefix_kv], dim=1)
            if self._sparse_prefill:
                self.model.refresh_slot_score_rows(self.cache, adm.slot)

    # -- prefill -------------------------------------------------------------

    def _run_chunk(self, ch: ChunkPlan):
        seq = ch.seq
        if seq.state != PREFILL:      # preempted after planning
            return
        if not self.scheduler._seq_chunkable(seq):
            # single-shot prefill has no rungs to fall back to: a step
            # fault goes straight to the sequence's failure budget.
            try:
                self._prefill_monolithic(seq)
            except _STEP_FAULTS as exc:
                self._tick_had_fault = True
                self._on_step_failure([seq], exc)
            return
        self._with_ladder(
            lambda exc: [seq],
            lambda rung: self._attempt_chunk(rung, ch),
        )

    def _attempt_chunk(self, rung: int, ch: ChunkPlan):
        """One ladder attempt at ``ch``: the chunk writes KV (and score
        rows) at explicit offsets, so a degraded re-run of the same chunk
        overwrites what a failed attempt wrote."""
        seq = ch.seq
        if self._fault is not None:
            self._fault.check_raise(
                "prefill", tick=self.metrics.ticks, seq_id=seq.seq_id
            )
        n = len(ch.tokens)
        buf = np.zeros((self._chunk_len,), np.int64)
        buf[:n] = ch.tokens
        logits, self.cache = self._rung_step_fns(rung)[1](
            self.cache, seq.slot, buf, ch.offset, n
        )
        if self._telemetry_on and self._sparse_prefill:
            self.metrics.on_prefill_sparsity(
                self.cache["_ptel"].cpu().numpy(),
                prefill_block_candidates(
                    self._plan_layouts, ch.offset, n,
                    self.cfg.sparse.prefill_block_q,
                ),
            )
        self._seq_len[seq.slot] = ch.offset + n
        self.metrics.on_prefill(n)
        if ch.is_last:
            self._finish_prefill(seq, logits[None])

    def _prefill_monolithic(self, seq: SeqState):
        """Single-shot prefill (``prefill_chunk`` 0): one
        ``Transformer.prefill`` of the prompt at ``max_context``, its
        one-sequence cache scattered into the batch slot."""
        if self._fault is not None:
            self._fault.check_raise(
                "prefill", tick=self.metrics.ticks, seq_id=seq.seq_id
            )
        if seq.req.prefix_emb is not None:
            raise NotImplementedError("prefix embeddings are not ported")
        tokens = torch.as_tensor(np.asarray(seq.prefill_tokens, np.int64))[None]
        logits, one = self.model.prefill(tokens, max_context=self.max_context)
        slot = seq.slot
        for e, e1 in zip(self.cache["layers"], one["layers"]):
            for name, t in e1.items():
                e[name][slot] = t[0]
        del one
        self._seq_len[slot] = seq.n_prefill
        self.metrics.on_prefill(seq.n_prefill)
        self._finish_prefill(seq, logits)

    def _finish_prefill(self, seq: SeqState, logits: torch.Tensor):
        """Prompt complete: sample the first token, rebuild the slot's decode
        store, publish the prompt's pages to the prefix cache.  The finite
        gate runs first, so a re-run of the chunk starts from the state the
        failed attempt saw."""
        if seq.replay:
            # resumed: the first committed token is the next decode input
            tok = seq.replay.pop(0)
            self.metrics.on_replay_token(seq.seq_id)
            resumed = True
        else:
            first, fin = self._sample([seq.seq_id], [len(seq.req.output)], logits)
            if not fin[0]:
                self.metrics.on_sampler_anomaly(1)
                raise SamplerAnomaly([seq.seq_id], detail="prefill logits")
            tok = int(first[0])
            resumed = False
        if self.scheduler._seq_chunkable(seq):
            # a monolithic prefill built the store itself
            self.model.refresh_slot_store(self.cache, seq.slot)
            if self.prefix_cache is not None:
                tokens = seq.prefill_tokens
                n_pages = len(tokens) // self.pool.page_size
                if n_pages:
                    pages = self.pool.table(seq.seq_id).physical[:n_pages]
                    self.prefix_cache.insert(
                        tokens, pages, self._page_snapshot_fn(seq.slot, n_pages)
                    )
        if not resumed:
            seq.req.output.append(tok)
            self.metrics.on_first_token(seq.seq_id)
            self.metrics.on_decode_token(seq.seq_id)
        self._tokens_buf[seq.slot] = tok
        seq.state = DECODE
        if self._is_finished(seq):
            self._retire(seq)
        else:
            # every restorable sequence carries a watermark from its first
            # committed token on
            self._take_checkpoint(seq)

    def _page_snapshot_fn(self, slot: int, n_pages: int):
        """Lazy snapshot of one slot's prompt-span KV, one page per call
        (copied on the device once, only if the insert adds new pages):
        ``{"k": [n_layers, n_kv, page, hd], "v": ...}``."""
        memo = {}

        def fn(i: int):
            if not memo:
                for name in ("k", "v"):
                    memo[name] = torch.stack(
                        [e[name][slot, :, :n_pages] for e in self.cache["layers"]]
                    )                                   # [L, n_kv, nP, ps, hd]
            return {"k": memo["k"][:, :, i], "v": memo["v"][:, :, i]}

        return fn

    # -- decode tick -----------------------------------------------------------

    def _is_finished(self, seq: SeqState) -> bool:
        out = seq.req.output
        hit_eos = seq.req.eos_token is not None and out and out[-1] == seq.req.eos_token
        return len(out) >= seq.req.max_new_tokens or bool(hit_eos)

    def _retire(self, seq: SeqState):
        self.scheduler.retire(seq)
        self._free_slot(seq)
        seq.req.done = True
        self.finished.append(seq.req)

    def _attempt_decode(self, rung: int, active: List[SeqState], res: Dict):
        """One ladder attempt at the batched decode step.  The host lengths
        are copied into the cache first (a failed attempt advanced them in
        place).  Tokens and the finite mask (one per ``active`` row) land
        in ``res`` before an anomaly raises, so at the floor the healthy
        rows still commit.  The anomaly counts as injected only when every
        non-finite row is one the injector poisoned."""
        if self._fault is not None:
            self._fault.check_raise("decode", tick=self.metrics.ticks)
        self.cache["seq_len"].copy_(torch.from_numpy(self._seq_len))
        logits, self.cache = self._rung_step_fns(rung)[0](
            self.cache, torch.from_numpy(self._tokens_buf)
        )
        lg = logits[[s.slot for s in active]]
        rows = []
        if self._fault is not None:
            rows = self._fault.poison_rows(
                self.metrics.ticks, [(s.seq_id, i) for i, s in enumerate(active)]
            )
            if rows:
                lg[rows] = float("nan")
        toks, fin = self._sample(
            [s.seq_id for s in active], [len(s.req.output) for s in active], lg,
        )
        res["tokens"], res["finite"] = toks, fin
        bad = np.flatnonzero(~fin).tolist()
        if bad:
            self.metrics.on_sampler_anomaly(len(bad))
            raise SamplerAnomaly([active[i].seq_id for i in bad],
                                 injected=set(bad) <= set(rows))

    def _decode_tick(self) -> int:
        active = [s for s in self.slots if s is not None and s.state == DECODE]
        if not active:
            return 0
        mem = self.memory
        if mem is not None:
            # {logical: physical} pages whose bytes sit in the host tier at
            # step launch; a selection overlapping them read poison, and the
            # sequence must stall and re-run
            host_before = {s.seq_id: mem.pool.host_resident_logical(s.seq_id)
                           for s in active}
        res: Dict[str, np.ndarray] = {}
        self._with_ladder(
            lambda exc: (
                [s for s in active if s.seq_id in exc.seq_ids]
                if isinstance(exc, SamplerAnomaly)
                else list(active)
            ),
            lambda rung: self._attempt_decode(rung, active, res),
        )
        if "tokens" in res:
            toks, fin = res["tokens"], res["finite"]
            if self._telemetry_on:
                # one fresh host copy per tick, after the token transfer
                tel = self.cache["_telemetry"].to("cpu", copy=True).numpy()
                self.metrics.on_sparsity(tel, [s.slot for s in active])
            if mem is not None:
                sel = self.cache["_sel_pages"].cpu().numpy()
                pre = self.cache["_pre_pages"].cpu().numpy()
            for seq, tok, ok in zip(active, toks, fin):
                slot = seq.slot
                if self.scheduler.running.get(seq.seq_id) is not seq or slot < 0:
                    continue    # restored / failed at the ladder floor
                if not ok:
                    continue    # anomalous row (already charged)
                if mem is not None and not mem.on_step(
                        seq, np.flatnonzero(sel[slot]), np.flatnonzero(pre[slot]),
                        host_before[seq.seq_id]):
                    # host-tier miss: the token is discarded and nothing
                    # advances; the next tick re-runs this slot's step once
                    # the missing pages are promoted (the rest of the batch
                    # commits)
                    continue
                if seq.replay:
                    # resume replay: the committed token is forced as input
                    self._tokens_buf[slot] = seq.replay.pop(0)
                    self._seq_len[slot] += 1
                    self.metrics.on_replay_token(seq.seq_id)
                    continue
                seq.req.output.append(int(tok))
                self._tokens_buf[slot] = int(tok)
                self._seq_len[slot] += 1
                self.metrics.on_decode_token(seq.seq_id)
                if self._is_finished(seq):
                    self._retire(seq)
                else:
                    ck = seq.checkpoint
                    if ck is None or (
                        len(seq.req.output) - ck.n_output
                        >= self.resilience.checkpoint_interval
                    ):
                        self._take_checkpoint(seq)
        # host lengths are authoritative (the step advanced every slot)
        self.cache["seq_len"].copy_(torch.from_numpy(self._seq_len))
        return len(active)

    def step(self) -> int:
        """One engine tick: admit, prefill chunks, decode, retire, under
        the watchdog.  -> the number of occupied slots."""
        self._tick_had_fault = False
        had_work = self.scheduler.has_work
        sig0 = self._progress_sig()
        if self._fault is not None and self._fault.fires(
                "tick_stuck", self.metrics.ticks):
            # injected stuck clock: the tick body is skipped, only the idle
            # accounting below runs — what the watchdog must catch
            decoded = 0
        else:
            decoded = self._tick_work()
            if self._rung > 0 and decoded and not self._tick_had_fault:
                # clean decode tick on a degraded rung
                self._clean_ticks += 1
                if self._clean_ticks >= self.resilience.repromote_after:
                    self._rung -= 1
                    self._clean_ticks = 0
                    self.metrics.on_repromote(self._ladder[self._rung][0])
        if had_work and self._progress_sig() == sig0:
            self._idle_ticks += 1
            if self._idle_ticks >= self.resilience.watchdog_ticks:
                self.metrics.on_watchdog(self._idle_ticks)
                self._idle_ticks = 0
                self._watchdog_break()
        else:
            self._idle_ticks = 0
        self.metrics.ticks += 1
        return len([s for s in self.slots if s is not None])

    def _progress_sig(self) -> tuple:
        """Counters that move whenever a tick does useful (or at least
        state-changing) work; the watchdog compares them across a tick."""
        m = self.metrics
        return (
            m.decode_tokens,
            m.prefill_tokens_computed,
            m.prefix_hit_tokens,
            len(self.finished),
            m.preemptions,
            m.checkpoints_restored,
            m.replayed_tokens,
            len(m.requests_failed),
            self.memory.queue.applied if self.memory is not None else 0,
        )

    def _watchdog_break(self):
        """``watchdog_ticks`` ticks without progress: preempt the
        scheduler's victim (farthest effective deadline) so whatever it
        pins frees up.  A no-op when nothing runs (every sequence in
        backoff)."""
        running = [s for s in self.slots if s is not None]
        if not running:
            return
        victim = self.scheduler.choose_victim(running)
        self.scheduler.preempt(victim)
        self._free_slot(victim)

    def _tick_work(self) -> int:
        """admit -> prefill chunks -> decode -> retire (one tick's work);
        -> the number of decoding slots stepped."""
        if self.memory is not None:
            # apply staged host -> device promotions (stall targets first,
            # then predictions into free headroom) and rebuild the demotion
            # shield before anything allocates or reads the cache
            self.memory.begin_tick()
            # starvation breaker: a stalled sequence whose miss-promotes
            # have failed for consecutive ticks is starved (the others'
            # working-set shields cover the whole budget), and
            # prepare_decode cannot help (stalled sequences hold their
            # reservation and are left out of it): preempt the scheduler's
            # victim among the starved, whose freed pages make room
            starved = [self.scheduler.running[sid]
                       for sid in self.memory.starved_seqs()
                       if sid in self.scheduler.running]
            if starved:
                victim = self.scheduler.choose_victim(starved)
                self.scheduler.preempt(victim)
                self._free_slot(victim)
        free = [i for i, s in enumerate(self.slots) if s is None]
        plan = self.scheduler.plan_tick(free)
        for adm in plan.admitted:
            self._install(adm)
        for ch in plan.chunks:
            self._run_chunk(ch)
        decoding = [s for s in self.slots if s is not None and s.state == DECODE]
        if self.memory is not None:
            # a stalled sequence already holds its next-token reservation
            # from the tick it missed on; reserving again would leak span
            decoding = [s for s in decoding if s.seq_id not in self.memory.stalled]
        for seq in self.scheduler.prepare_decode(decoding):
            self._free_slot(seq)
        decoded = self._decode_tick()
        if self.memory is not None:
            self.memory.end_tick()
        return decoded

    def run_until_done(
        self,
        max_ticks: int = 10_000,
        tick_callback: Optional[Callable[["Engine", int], None]] = None,
    ) -> List[Request]:
        """Tick until queue and slots drain -> the requests retired during
        this call, in retirement order (failed ones included).
        ``tick_callback(engine, tick)`` runs after every tick.  Raises
        :class:`EngineStalled` (with diagnostics and the requests retired so
        far) when ``max_ticks`` pass with work pending."""
        start = len(self.finished)
        for tick in range(max_ticks):
            self.step()
            if tick_callback is not None:
                tick_callback(self, tick)
            if not self.scheduler.has_work:
                break
        else:
            if self.scheduler.has_work:
                raise EngineStalled(
                    f"max_ticks={max_ticks} exhausted with "
                    f"{len(self.scheduler.waiting)} queued and "
                    f"{len(self.scheduler.running)} running requests",
                    diagnostics=self.diagnostics(),
                    retired=list(self.finished[start:]),
                )
        return list(self.finished[start:])
