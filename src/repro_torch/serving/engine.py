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

Not ported (each raises ``NotImplementedError`` when asked for): tiered KV
memory (``ServeConfig.hbm_pages``), a device mesh, tracing and fault
injection.  There is no degradation ladder (fused -> staged -> reference):
a kernel fault raises.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.cache.paged_kv import PagePool
from repro_torch.cache.prefix_cache import PrefixCache
from repro_torch.config import ModelConfig, ServeConfig
from repro_torch.models import Transformer, resolve_device
from repro_torch.obs.telemetry import (
    N_COUNTERS,
    SparsityAggregate,
    prefill_block_candidates,
)
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
    """``run_until_done`` exhausted its tick budget with work still queued."""


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
        fault_injector=None,
        telemetry: bool = False,
    ):
        """``model`` holds the weights (a :class:`Transformer` on
        ``device``); batch capacity and context length come from
        ``serve_cfg``.  ``telemetry`` turns on the sparsity counters."""
        for name, val in (("mesh", mesh), ("trace", trace),
                          ("fault_injector", fault_injector),
                          ("ServeConfig.hbm_pages", serve_cfg.hbm_pages)):
            if val is not None:
                raise NotImplementedError(f"{name} is not ported")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        self.cfg = model_cfg
        self.serve = serve_cfg
        self.model = model
        self.seed = seed
        self.pool = PagePool(
            total_pages=serve_cfg.pool_pages
            or self.max_batch * (self.max_context // serve_cfg.page_size),
            page_size=serve_cfg.page_size,
        )
        self.cache = model.init_cache(self.max_batch, self.max_context)
        self.slots: List[Optional[SeqState]] = [None] * self.max_batch
        self.finished: List[Request] = []
        self.metrics = ServingMetrics(clock=clock)
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

    @property
    def max_batch(self) -> int:
        return self.serve.max_batch

    @property
    def max_context(self) -> int:
        return self.serve.max_context

    # -- sampling -------------------------------------------------------------

    def _sample(self, seq_ids, positions, logits):
        fin = finite_mask(logits).cpu().numpy()
        toks = sample(
            logits, seq_ids, positions, self.serve.temperature,
            self.serve.top_k, self.serve.top_p, seed=self.seed,
        )
        return toks.cpu().numpy(), fin

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
        """Occupy the slot; copy prefix-cache KV pages into its rows and,
        under sparse prefill, rebuild its score segment (the installed span
        never ran a chunk)."""
        seq = adm.seq
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
            self._prefill_monolithic(seq)
            return
        n = len(ch.tokens)
        buf = np.zeros((self._chunk_len,), np.int64)
        buf[:n] = ch.tokens
        logits, self.cache = self.model.prefill_chunk(
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
        store, publish the prompt's pages to the prefix cache."""
        if seq.replay:
            tok = seq.replay.pop(0)
            resumed = True
        else:
            first, fin = self._sample([seq.seq_id], [len(seq.req.output)], logits)
            if not fin[0]:
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
        self.slots[seq.slot] = None
        self._seq_len[seq.slot] = 0
        seq.req.done = True
        self.finished.append(seq.req)
        seq.slot = -1

    def _decode_tick(self) -> int:
        active = [s for s in self.slots if s is not None and s.state == DECODE]
        if not active:
            return 0
        self.cache["seq_len"].copy_(torch.from_numpy(self._seq_len))
        logits, self.cache = self.model.decode_step(
            self.cache, torch.from_numpy(self._tokens_buf)
        )
        rows = [s.slot for s in active]
        toks, fin = self._sample(
            [s.seq_id for s in active], [len(s.req.output) for s in active],
            logits[rows],
        )
        bad = [s.seq_id for s, ok in zip(active, fin) if not ok]
        if bad:
            raise SamplerAnomaly(bad)
        if self._telemetry_on:
            # one fresh host copy per tick, after the token transfer
            tel = self.cache["_telemetry"].to("cpu", copy=True).numpy()
            self.metrics.on_sparsity(tel, rows)
        for seq, tok in zip(active, toks):
            slot = seq.slot
            if seq.replay:
                # resume replay: the committed token is forced as input
                self._tokens_buf[slot] = seq.replay.pop(0)
                self._seq_len[slot] += 1
                continue
            seq.req.output.append(int(tok))
            self._tokens_buf[slot] = int(tok)
            self._seq_len[slot] += 1
            self.metrics.on_decode_token(seq.seq_id)
            if self._is_finished(seq):
                self._retire(seq)
        self.cache["seq_len"].copy_(torch.from_numpy(self._seq_len))
        return len(active)

    def step(self) -> int:
        """One engine tick: admit, prefill chunks, decode, retire.
        -> the number of occupied slots."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        plan = self.scheduler.plan_tick(free)
        for adm in plan.admitted:
            self._install(adm)
        for ch in plan.chunks:
            self._run_chunk(ch)
        decoding = [s for s in self.slots if s is not None and s.state == DECODE]
        for seq in self.scheduler.prepare_decode(decoding):
            self.slots[seq.slot] = None
            self._seq_len[seq.slot] = 0
            seq.slot = -1
        self._decode_tick()
        self.metrics.ticks += 1
        return len([s for s in self.slots if s is not None])

    def run_until_done(self, max_ticks: int = 10_000) -> List[Request]:
        """Tick until queue and slots drain -> the requests retired during
        this call, in retirement order."""
        start = len(self.finished)
        for _ in range(max_ticks):
            self.step()
            if not self.scheduler.has_work:
                break
        else:
            if self.scheduler.has_work:
                raise EngineStalled(
                    f"max_ticks={max_ticks} exhausted with "
                    f"{len(self.scheduler.waiting)} queued and "
                    f"{len(self.scheduler.running)} running requests"
                )
        return list(self.finished[start:])
