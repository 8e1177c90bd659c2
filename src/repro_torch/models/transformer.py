"""Dense decoder with AB-Sparse attention (counterpart of
``repro.models.transformer`` for the ``("attn",)`` pattern).

Entry points:
  prefill          prompt -> KV cache + decode store (+ prefill score
                   segment under sparse prefill)
  prefill_chunk    one prompt chunk of one batch slot
  decode_step      one token for every slot: score -> top-K_h -> attend
                   (fused kernel or staged, ``SparseConfig.fused_decode``)

Prefill is query-block sparse when ``SparseConfig.sparse_prefill`` is on
and the plan is active; otherwise (the default) it is dense causal
attention (``AttentionBackend.causal_attention``: the flash kernel, with
the chunk's offset and live length for a chunk).  Decode is sparse when
the plan is active at ``max_context`` (``context >= 2 x budget``), and
attends every live token when it is not (``AttentionBackend.dense_decode``)
or on the ``"dense"`` backend (whose ``decode`` runs the same); an inactive
plan allocates no store.

The JAX model scans over stacked layer parameters and donates its cache;
here the layers are a Python loop over per-layer cache tensors, and every
cache tensor (KV pages, stores, ``seq_len``) is updated in place.  The KV
cache is always the paged ``[B, n_kv, n_pages, page, hd]`` tensor, viewed
as JAX's dense ``[B, n_kv, S, hd]`` where JAX holds that layout (the
bytes are the same).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.backends import AttentionPlan, CentroidStore, build_plan, get_backend
from repro_torch.config import ModelConfig
from repro_torch.core.centroids import rank_query
from repro_torch.core.quantization import store_bits, store_symmetric
from repro_torch.core.selection import selected_page_masks
from repro_torch.models import layers
from repro_torch.models.layers import DecoderLayer

Cache = Dict[str, Any]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must be present when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "versions of the kernels on the CPU"
        )
    return dev


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.layer_pattern != ("attn",):
            raise NotImplementedError(
                f"layer pattern {cfg.layer_pattern} is not ported (dense "
                "('attn',) stacks only)"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        d = cfg.d_model
        mk = lambda shape: nn.Parameter(
            torch.empty(shape, dtype=self.dtype, device=self.device),
            requires_grad=False,
        )
        self.embed = mk((cfg.vocab_size, d))
        self.final_norm = mk((d,))
        self.lm_head = None if cfg.tie_embeddings else mk((d, cfg.vocab_size))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, self.dtype, self.device) for _ in range(cfg.n_layers)
        )
        self.backend = get_backend(cfg.sparse.backend)

    def with_sparse(self, **overrides) -> "Transformer":
        """This model under another :class:`SparseConfig` (``overrides`` of
        its fields): a shallow copy with its own ``cfg`` and ``backend``
        and the same parameter tensors and submodules (no weight is
        copied).  The serving engine's degradation
        ladder runs its lower rungs through such views; caches are shared
        too, as long as the overrides keep the cache layout (backend,
        fused or staged decode, sparse prefill)."""
        cfg = dataclasses.replace(
            self.cfg, sparse=dataclasses.replace(self.cfg.sparse, **overrides))
        view = copy.copy(self)
        view.cfg, view.backend = cfg, get_backend(cfg.sparse.backend)
        return view

    # ------------------------------------------------------------------ init

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Transformer":
        """Random weights from ``generator``: truncated normals (+-2 std) with
        std 0.02 for the embedding and ``d_in ** -0.5`` for projections, ones
        for the norms (the distribution of ``repro``'s init; the numbers
        differ)."""

        def trunc(p, std):
            tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            p.copy_(tmp)

        trunc(self.embed, 0.02)
        self.final_norm.fill_(1.0)
        if self.lm_head is not None:
            trunc(self.lm_head, self.cfg.d_model ** -0.5)
        for layer in self.layers:
            for name, p in layer.named_parameters():
                if name.startswith("norm"):
                    p.fill_(1.0)
                elif name.startswith("b"):
                    p.zero_()
                else:
                    trunc(p, p.shape[0] ** -0.5)
        return self

    # -------------------------------------------------------------- layouts

    def attention_plan(self, context_len: int) -> AttentionPlan:
        return build_plan(self.cfg, context_len)

    def use_sparse(self, context_len: int) -> bool:
        return self.attention_plan(context_len).active

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        w = self.embed.T if self.lm_head is None else self.lm_head
        return torch.matmul(h, w)

    # ----------------------------------------------------------------- cache

    def init_cache(self, batch: int, max_context: int) -> Cache:
        """Per-layer paged KV pools for ``batch`` sequences of up to
        ``max_context`` tokens, with the decode stores when the plan is
        active and the prefill score segments when sparse prefill runs too.

        An active plan holds ``max_context // page_size`` pages, as JAX's
        paged cache does; an inactive one, whose JAX cache is dense, pads
        the last page (``ceil(max_context / page_size)`` pages, the rows
        past ``max_context`` never written nor attended)."""
        cfg, sp = self.cfg, self.cfg.sparse
        hd, ps = cfg.resolved_head_dim, sp.page_size
        plan = self.attention_plan(max_context)
        dev = self.device
        n_pages = max_context // ps if plan.active else -(-max_context // ps)
        kv_shape = (batch, cfg.n_kv_heads, n_pages, ps, hd)
        if plan.active:
            stk = plan.stacked(dev)
            Dp, bits = plan.rank_key_width, store_bits(sp.quant)
            cw = Dp // 2 if bits == 4 else Dp
            cdt = torch.uint8 if bits else torch.float32
            rows = stk.total_rows
        entries = []
        for _ in range(cfg.n_layers):
            e = {"k": torch.zeros(kv_shape, dtype=self.dtype, device=dev),
                 "v": torch.zeros(kv_shape, dtype=self.dtype, device=dev)}
            if plan.active:
                e["codes"] = torch.zeros((batch, rows, cw), dtype=cdt, device=dev)
                e["scale"] = torch.ones((batch, cfg.n_kv_heads, Dp),
                                        dtype=torch.float32, device=dev)
                e["zero"] = torch.zeros((batch, cfg.n_kv_heads, Dp),
                                        dtype=torch.float32, device=dev)
            if plan.active and sp.sparse_prefill:
                e["pcodes"] = torch.zeros((batch, rows, cw), dtype=cdt, device=dev)
                e["pscale"] = torch.ones((batch, rows, 1), dtype=torch.float32,
                                         device=dev)
                e["pzero"] = torch.zeros((batch, rows, 1), dtype=torch.float32,
                                         device=dev)
            entries.append(e)
        cache = {
            "seq_len": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "layers": entries,
            "la": ([stk.layer(l) for l in range(cfg.n_layers)] if plan.active
                   else [None] * cfg.n_layers),
            "max_context": max_context,
        }
        return cache

    @staticmethod
    @torch.no_grad()
    def clear_slot(cache: Cache, slot: int) -> Cache:
        """Reset batch slot ``slot``'s rows to :meth:`init_cache`'s values,
        in place: zero K/V, codes and offsets, unit scales.  The decode
        store's affine params span every block of the slot, the rows past
        the live length included, so a reused slot would otherwise quantize
        against its previous occupant's rows (or tiered memory's poison)."""
        for e in cache["layers"]:
            for name, t in e.items():
                t[slot].fill_(1.0 if name in ("scale", "pscale") else 0)
        return cache

    @staticmethod
    def _active(cache: Cache) -> bool:
        return cache["la"][0] is not None

    @staticmethod
    def _has_score_segment(cache: Cache) -> bool:
        return "pcodes" in cache["layers"][0]

    def _sparse_prefill(self, cache: Cache) -> bool:
        """Prefill runs query-block sparse when this model's config asks for
        it and the cache holds the score segment (a model with
        ``sparse_prefill`` off runs dense chunks on a cache built with it
        on, and leaves the segment untouched)."""
        return self.cfg.sparse.sparse_prefill and self._has_score_segment(cache)

    def _store(self, e) -> CentroidStore:
        quant = self.cfg.sparse.quant
        return CentroidStore(e["codes"], e["scale"], e["zero"],
                             store_bits(quant), store_symmetric(quant))

    # --------------------------------------------------------------- prefill

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                max_context: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens ``[B, S]`` -> (last-token logits [B, vocab], cache)."""
        cfg, sp = self.cfg, self.cfg.sparse
        tokens = torch.as_tensor(tokens, device=self.device).long()
        B, S = tokens.shape
        max_context = S if max_context is None else max_context
        cache = self.init_cache(B, max_context)
        active, use_sp = self._active(cache), self._sparse_prefill(cache)
        hd = cfg.resolved_head_dim
        S_max = cache["layers"][0]["k"].shape[2] * sp.page_size
        positions = torch.arange(S, device=self.device)[None]
        if use_sp:
            n_valid = torch.full((B,), S, dtype=torch.int32, device=self.device)
        x = self.embed[tokens]
        for layer, e, la in zip(self.layers, cache["layers"], cache["la"]):
            h = layers.rms_norm(x, layer.norm1, cfg.norm_eps)
            q, k, v = layers.qkv_project(layer, h, cfg, positions)
            kd = e["k"].view(B, cfg.n_kv_heads, S_max, hd)
            vd = e["v"].view(B, cfg.n_kv_heads, S_max, hd)
            kd[:, :, :S] = k.transpose(1, 2)
            vd[:, :, :S] = v.transpose(1, 2)
            if use_sp:
                store, score = self.backend.prefill_stores(e["k"], la, sp)
                for name, t in (("pcodes", score.codes), ("pscale", score.scale),
                                ("pzero", score.zero)):
                    e[name].copy_(t)
            elif active:
                store = self.backend.prefill_store(e["k"], la, sp)
            if active:
                for name, t in (("codes", store.codes), ("scale", store.scale),
                                ("zero", store.zero)):
                    e[name].copy_(t)
            if use_sp:
                attn, _ = self.backend.prefill_attention(
                    q.transpose(1, 2), e["k"], e["v"], score, la, sp,
                    n_valid=n_valid,
                )
            else:
                attn = self.backend.causal_attention(q.transpose(1, 2), kd, vd)
            x = x + layers.out_project(layer, attn.transpose(1, 2))
            h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
            x = x + layers.mlp(layer, h, cfg.activation)
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        cache["seq_len"].fill_(S)
        return self.unembed(x[:, -1]), cache

    @torch.no_grad()
    def prefill_chunk(self, cache: Cache, slot: int, tokens, offset: int,
                      n_valid: int) -> Tuple[torch.Tensor, Cache]:
        """Process one prompt chunk of batch slot ``slot`` in place.

        ``tokens`` is the chunk buffer (its length sizes the score-refresh
        window, as the JAX model's compiled chunk shape does); only its first
        ``n_valid`` tokens are processed and written at rows
        ``[offset, offset + n_valid)``.  Dense (the default): each chunk
        query attends the slot's keys up to its own position.  Under sparse
        prefill (the cache holds the score segment), ``offset`` must be a
        multiple of ``SparseConfig.prefill_block_q``; the slot's running
        score segment is refreshed with the blocks the chunk completes,
        then each query block attends its forced + top-scored blocks.  The
        decode store is not maintained: call :meth:`refresh_slot_store`
        after the last chunk.  When the cache carries ``"_ptel"``
        (``[n_layers]`` int32), each sparse layer's entry is set to the
        number of (query block, key block) pairs it attended.
        -> (logits [vocab] at the last valid position, cache)."""
        cfg, sp = self.cfg, self.cfg.sparse
        C = len(tokens)
        tok = torch.as_tensor(tokens, device=self.device).long()[:n_valid]
        n_kv, hd, ps = cfg.n_kv_heads, cfg.resolved_head_dim, sp.page_size
        S_max = cache["layers"][0]["k"].shape[2] * ps
        use_sp = self._sparse_prefill(cache)
        if (use_sp and offset % sp.prefill_block_q) or offset + n_valid > S_max:
            raise ValueError(f"chunk [{offset}, {offset + n_valid}) is not "
                             f"query-block aligned or exceeds {S_max}")
        bits, sym = store_bits(sp.quant), store_symmetric(sp.quant)
        bmax = sp.max_block_size
        window = min(-(-(C + 2 * bmax) // bmax) * bmax, S_max)
        positions = (offset + torch.arange(n_valid, device=self.device))[None]
        x = self.embed[tok][None]                           # [1, n, d]
        ptel = cache.get("_ptel")
        for l, (layer, e, la) in enumerate(
                zip(self.layers, cache["layers"], cache["la"])):
            h = layers.rms_norm(x, layer.norm1, cfg.norm_eps)
            q, k, v = layers.qkv_project(layer, h, cfg, positions)
            kslot, vslot = e["k"][slot], e["v"][slot]       # [n_kv, nP, ps, hd]
            kd, vd = kslot.view(n_kv, S_max, hd), vslot.view(n_kv, S_max, hd)
            kd[:, offset:offset + n_valid] = k[0].transpose(0, 1)
            vd[:, offset:offset + n_valid] = v[0].transpose(0, 1)
            if use_sp:
                sstore = CentroidStore(e["pcodes"][slot][None],
                                       e["pscale"][slot][None],
                                       e["pzero"][slot][None], bits, sym)
                self.backend.refresh_score_rows(
                    sstore, kslot[None], la, offset, offset + n_valid, sp, window
                )
                attn, n_att = self.backend.prefill_attention(
                    q.transpose(1, 2), kslot[None], vslot[None], sstore, la, sp,
                    n_valid=offset + n_valid, chunk_offset=offset,
                )
                if ptel is not None and n_att is not None:
                    ptel[l] = n_att.sum()
            else:
                attn = self.backend.causal_attention(
                    q.transpose(1, 2), kd[None], vd[None], offset,
                    offset + n_valid)
            x = x + layers.out_project(layer, attn.transpose(1, 2))
            h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
            x = x + layers.mlp(layer, h, cfg.activation)
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.unembed(x[0, n_valid - 1]), cache

    @torch.no_grad()
    def refresh_slot_store(self, cache: Cache, slot: int) -> Cache:
        """Rebuild one slot's decode-store rows from its K cache, in place
        (same builder as :meth:`prefill`, so the bytes are identical); no-op
        when the plan is inactive (no store)."""
        if not self._active(cache):
            return cache
        for e, la in zip(cache["layers"], cache["la"]):
            st = self.backend.prefill_store(e["k"][slot][None], la,
                                            self.cfg.sparse)
            e["codes"][slot] = st.codes[0]
            e["scale"][slot] = st.scale[0]
            e["zero"][slot] = st.zero[0]
        return cache

    @torch.no_grad()
    def refresh_slot_score_rows(self, cache: Cache, slot: int) -> Cache:
        """Rebuild one slot's prefill score segment from its K cache, in
        place (after a prefix-cache install, whose KV never ran a chunk);
        no-op without sparse prefill (no score segment)."""
        if not self._has_score_segment(cache):
            return cache
        for e, la in zip(cache["layers"], cache["la"]):
            st = self.backend.prefill_score_rows(e["k"][slot][None], la,
                                                 self.cfg.sparse)
            e["pcodes"][slot] = st.codes[0]
            e["pscale"][slot] = st.scale[0]
            e["pzero"][slot] = st.zero[0]
        return cache

    # ------------------------------------------------------------ decode step

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens) -> Tuple[torch.Tensor, Cache]:
        """One token for every slot at position ``cache["seq_len"]``.
        -> (logits [B, vocab], cache); ``seq_len`` is advanced in place.
        When the cache carries ``"_telemetry"`` (``[n_layers, B, 4]``
        int32), each sparse layer's slice is set to the decode's sparsity
        counters (:func:`~repro_torch.core.selection.selection_telemetry`);
        dense decode (inactive plan, ``"dense"`` backend) sets nothing.
        When it carries ``"_sel_pages"`` and ``"_pre_pages"`` (``[B,
        n_pages]`` bool, planted by tiered KV memory) and the plan is
        active, every layer re-runs the estimation on its store after the
        append and the two are set to the selected and margin-predicted
        pages of the step, OR-ed over heads and layers (on the ``"dense"``
        backend too, as in JAX).  An inactive plan decodes through
        ``AttentionBackend.dense_decode``, an active one through the
        backend's ``append`` and ``decode``."""
        cfg, sp = self.cfg, self.cfg.sparse
        tok = torch.as_tensor(tokens, device=self.device).long()
        B = tok.shape[0]
        seq_len = cache["seq_len"]
        positions = seq_len[:, None].long()
        ps = sp.page_size
        bidx = torch.arange(B, device=self.device)
        k0 = cache["layers"][0]["k"]
        # the rows JAX holds: max_context // ps pages when paged, max_context
        # when dense (an inactive plan's padded page rows are never used)
        S_lim = min(cache["max_context"], k0.shape[2] * ps)
        # JAX drops a write at position S_lim; keep the old row there instead.
        in_range = (seq_len < S_lim)[:, None, None]
        pos = torch.clamp(seq_len.long(), max=S_lim - 1)
        page, within = pos // ps, pos % ps
        # every layer of a step that attends every live token (inactive
        # plan, or the "dense" backend) reads one identity page table
        dense, table = not self._active(cache), None
        if dense or self.backend.full_attention:
            live = torch.clamp(seq_len + 1, max=S_lim)
            table = self.backend.full_page_table(k0, live)
        x = self.embed[tok][:, None]                        # [B, 1, d]
        tel = cache.get("_telemetry")
        # tiered KV memory plants "_sel_pages" / "_pre_pages" [B, n_pages]:
        # every sparse layer then reports its selected and margin-predicted
        # pages, OR-ed over layers
        masks = [None, None] if not dense and "_sel_pages" in cache else None
        for l, (layer, e, la) in enumerate(
                zip(self.layers, cache["layers"], cache["la"])):
            h = layers.rms_norm(x, layer.norm1, cfg.norm_eps)
            q, k_new, v_new = layers.qkv_project(layer, h, cfg, positions)
            for name, new in (("k", k_new[:, 0]), ("v", v_new[:, 0])):
                old = e[name][bidx, :, page, within]         # [B, n_kv, hd]
                e[name][bidx, :, page, within] = torch.where(in_range, new, old)
            if dense:
                out = self.backend.dense_decode(q[:, 0], e["k"], e["v"], live,
                                                ps, table)
            else:
                store = self._store(e)
                self.backend.append(store, e["k"], la, seq_len, sp)
                res = self.backend.decode(
                    q[:, 0], e["k"], e["v"], store, la, sp, seq_len + 1,
                    collect_tel=tel is not None, page_table=table,
                )
                out = res[0]
                if tel is not None and res[3] is not None:
                    tel[l] = res[3]
                if masks is not None:
                    for i, m in enumerate(self._page_masks(q[:, 0], e, la,
                                                           seq_len + 1)):
                        masks[i] = m if masks[i] is None else masks[i] | m
            x = x + layers.out_project(layer, out[:, None])
            h = layers.rms_norm(x, layer.norm2, cfg.norm_eps)
            x = x + layers.mlp(layer, h, cfg.activation)
        x = layers.rms_norm(x, self.final_norm, cfg.norm_eps)
        if masks is not None:
            cache["_sel_pages"].copy_(masks[0])
            cache["_pre_pages"].copy_(masks[1])
        seq_len += 1
        return self.unembed(x[:, 0]), cache

    def _page_masks(self, q, e, la, live):
        """(selected, predicted) page masks ``[B, n_pages]`` of one sparse
        layer's decode: the estimation re-run on the store after the append
        (the scores the decode just selected from), then
        :func:`~repro_torch.core.selection.selected_page_masks`."""
        sp = self.cfg.sparse
        rq = rank_query(q, sp.centroid_method, q.shape[-1])
        est = self.backend.scores(rq, self._store(e), la, e["k"].shape[1])
        return selected_page_masks(
            est, la, live, sp.sink_pages, sp.local_pages,
            sp.prefetch_margin_blocks, sp.max_block_size // sp.page_size)
