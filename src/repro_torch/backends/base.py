"""Attention plan, centroid store and backends (counterpart of
``repro.backends.base``).

- :class:`AttentionPlan`: the per-layer ragged layouts for one
  ``(model_cfg, context_len)``; sparse attention is active only when
  ``context_len >= 2 * budget``.
- :class:`CentroidStore`: the flattened ragged rank-key store (INT4
  split-half packed codes, per-(sequence, head, channel) or per-row affine
  params), shared by both backends; :meth:`CentroidStore.quantize_heads`
  is the offline store's one quantization path.
- :class:`AttentionBackend`: store build / maintenance (``build_store``
  pools raw keys into rank keys: per head through the plain version on
  ``"reference"``, one ``pool_rank_keys`` kernel launch per distinct block
  size on ``"cuda"``), sparse prefill and decode.  ``"reference"`` runs
  the kernels' plain versions and always decodes staged; ``"cuda"``
  launches the hand-written kernels (their plain versions on CPU tensors)
  and decodes with the fused kernel when ``SparseConfig.fused_decode`` is
  set, else staged: the scoring kernel, the stable-sort selection, the
  paged-attention kernel.  Both also run the dense attention of the
  default configuration (:meth:`AttentionBackend.causal_attention`, dense
  prefill) and of the inactive plan (:meth:`AttentionBackend.dense_decode`);
  ``"dense"`` (:mod:`repro_torch.backends.dense`) decodes that way always.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, SparseConfig
from repro_torch.core.centroids import padded_rank_key_width, rank_query
from repro_torch.core.quantization import (
    affine_params_from_minmax,
    encode_affine,
    pack_split_half,
    store_bits,
    store_symmetric,
)
from repro_torch.core.ragged import RaggedLayout, layout_for
from repro_torch.core.selection import (
    rank_blocks,
    select_page_table,
    selection_telemetry,
)
from repro_torch.core.sparse_attention import (
    as_dense,
    as_paged,
    dense_decode_attention,
)
from repro_torch.core.stacked import LayoutArrays, stack_layouts
from repro_torch.distributed.kernel_partition import decode_split, prefill_split


@dataclass
class CentroidStore:
    """``codes``: ``[B, rows, Dp]`` f32 (bits 0), ``[B, rows, Dp]`` uint8
    (INT8) or ``[B, rows, Dp // 2]`` uint8 (INT4).  ``scale``/``zero``:
    ``[B, n_kv, Dp]`` for the decode store, ``[B, rows, 1]`` for the
    prefill score segment."""

    codes: torch.Tensor
    scale: Optional[torch.Tensor]
    zero: Optional[torch.Tensor]
    bits: int
    symmetric: bool = False

    def dequantize(self, la: LayoutArrays) -> torch.Tensor:
        """-> f32 rank keys ``[B, rows, Dp]`` of a decode store (the bytes
        the kernels dequantize in registers)."""
        from repro_torch.kernels.ref import dequant_store_rows

        return dequant_store_rows(self.codes, self.scale, self.zero, la,
                                  self.bits, self.symmetric)

    @classmethod
    def quantize_heads(
        cls,
        per_head_rank_keys: Sequence[torch.Tensor],   # n_kv x [B, nb_h, Dp]
        layout: RaggedLayout,
        quant: Optional[str],
    ) -> "CentroidStore":
        """Per-head rank keys -> flattened store: per-(sequence, head,
        channel) affine params over the head's block rows, codes padded to
        the layout's row tiles, INT4 split-half packed (``scale`` / ``zero``
        None for an f32 store)."""
        bits, symmetric = store_bits(quant), store_symmetric(quant)
        if bits not in (0, 4, 8):
            raise ValueError(
                f"centroid store supports none/int8/int4 schemes, got {quant!r}"
            )
        segs, scales, zeros = [], [], []
        for h, rk in enumerate(per_head_rank_keys):
            rk = rk.to(torch.float32)                         # [B, nb, Dp]
            if bits:
                xmin = rk.amin(dim=1, keepdim=True)
                xmax = rk.amax(dim=1, keepdim=True)
                scale, zero = affine_params_from_minmax(xmin, xmax, bits, symmetric)
                rk = encode_affine(rk, scale, zero, bits, symmetric)
                scales.append(scale[:, 0])                    # [B, Dp]
                zeros.append(zero[:, 0])
            segs.append(F.pad(rk, (0, 0, 0, layout.padded_n_blocks[h] - rk.shape[1])))
        codes = torch.cat(segs, dim=1)                        # [B, rows, Dp]
        if bits == 0:
            return cls(codes.contiguous(), None, None, 0, False)
        if bits == 4:
            codes = pack_split_half(codes)                    # [B, rows, Dp // 2]
        return cls(codes.contiguous(), torch.stack(scales, dim=1),
                   torch.stack(zeros, dim=1), bits, symmetric)


@dataclass(frozen=True)
class AttentionPlan:
    backend: str
    sparse: SparseConfig
    n_layers: int
    n_kv_heads: int
    head_dim: int
    context_len: int
    active: bool
    layouts: Tuple[RaggedLayout, ...] = ()

    @property
    def rank_key_width(self) -> int:
        return padded_rank_key_width(self.head_dim, self.sparse.centroid_method)

    def stacked(self, device) -> LayoutArrays:
        """All layer layouts as one ``[L, ...]`` tensor stack on ``device``."""
        return stack_layouts(list(self.layouts), device)


@functools.lru_cache(maxsize=128)
def build_plan(model_cfg: ModelConfig, context_len: int) -> AttentionPlan:
    """The one place layouts are derived from a model config and context:
    active when AB-Sparse is enabled, some layer attends and the context
    holds at least twice the budget, as in JAX."""
    sp = model_cfg.sparse
    active = (sp.enabled and not model_cfg.is_attention_free
              and context_len >= 2 * sp.budget_for(context_len))
    layouts: Tuple[RaggedLayout, ...] = ()
    if active:
        budget = sp.budget_for(context_len)
        layouts = tuple(
            layout_for(
                sp.layer_block_sizes(l, model_cfg.n_kv_heads),
                context_len, sp.page_size, budget,
            )
            for l in range(model_cfg.n_layers)
        )
    return AttentionPlan(
        backend=sp.backend, sparse=sp, n_layers=model_cfg.n_layers,
        n_kv_heads=model_cfg.n_kv_heads,
        head_dim=model_cfg.resolved_head_dim, context_len=context_len,
        active=active, layouts=layouts,
    )


class AttentionBackend:
    """Store build / maintenance is shared (byte-identical stores whatever
    runs attention); prefill and decode run the kernels, or the plain
    versions when ``plain`` is set."""

    name: str = "?"
    plain: bool = True
    #: decodes over every live token (the Full Attention baseline)
    full_attention: bool = False

    # -- stores ---------------------------------------------------------------

    def _pool_rank_keys(self, keys: torch.Tensor, layout: RaggedLayout,
                        method: str) -> List[torch.Tensor]:
        """keys ``[B, n_kv, S, D]`` -> per-head rank keys (n_kv x
        ``[B, S / B_h, Dp]``)."""
        raise NotImplementedError

    def build_store(self, keys: torch.Tensor, layout: RaggedLayout,
                    method: str = "quest",
                    quant: Optional[str] = "int4_asym") -> CentroidStore:
        """Offline store build from dense keys ``[B, n_kv, S, D]`` (the
        calibration pass, benchmarks, tests)."""
        per_head = self._pool_rank_keys(keys, layout, method)
        return CentroidStore.quantize_heads(per_head, layout, quant)

    def prefill_store(self, k_cache, la, sparse) -> CentroidStore:
        from repro_torch.backends.store import build_store_codes

        return build_store_codes(k_cache, la, sparse)

    def prefill_score_rows(self, k_cache, la, sparse, sel_nb=None) -> CentroidStore:
        from repro_torch.backends.store import build_score_rows

        q = sparse.quant
        codes, scale, zero = build_score_rows(k_cache, la, sparse, q, sel_nb)
        return CentroidStore(codes, scale, zero, store_bits(q), store_symmetric(q))

    def prefill_stores(self, k_cache, la, sparse):
        """(decode store, prefill score segment) from one page-stats pass."""
        from repro_torch.backends.store import _selected_rank_keys, build_store_codes

        sel_nb = _selected_rank_keys(k_cache, la, sparse)
        store = build_store_codes(k_cache, la, sparse, sel_nb=sel_nb)
        score = self.prefill_score_rows(k_cache, la, sparse, sel_nb=sel_nb)
        return store, score

    def refresh_score_rows(self, score_store: CentroidStore, k_cache, la,
                           chunk_start: int, chunk_end: int, sparse,
                           window: int) -> CentroidStore:
        """Re-encode, in place, the score rows completed by a chunk."""
        from repro_torch.backends.store import refresh_score_rows

        refresh_score_rows(
            score_store.codes, score_store.scale, score_store.zero, k_cache,
            la, chunk_start, chunk_end, sparse, window,
            score_store.bits, score_store.symmetric,
        )
        return score_store

    def append(self, store: CentroidStore, k_cache, la, seq_len, sparse):
        """Refresh, in place, the row of the block holding the newest token."""
        from repro_torch.backends.store import refresh_tail_codes

        refresh_tail_codes(store, k_cache, la, seq_len, sparse)
        return store

    # -- attention ----------------------------------------------------------

    def prefill_attention(self, q, k, v, score_store, la, sparse,
                          n_valid=None, chunk_offset: int = 0, shard=None):
        """Query-block sparse prefill -> (out [B, Hq, Sq, D],
        n_attended [B, n_kv, nQB]).  ``shard`` (a
        :class:`~repro_torch.distributed.kernel_partition.Shard`; so for
        every method that takes one): the inputs are a mesh rank's heads,
        the kernel runs at the whole call's split, the output holds those
        heads."""
        from repro_torch.kernels import ops

        rq = rank_query(q, sparse.centroid_method, q.shape[-1])
        fn = (ops.sparse_prefill_reference if self.plain else functools.partial(
            ops.sparse_prefill,
            n_split=prefill_split(shard, q, sparse.prefill_block_q)))
        return fn(
            q, rq, k, v, score_store, la,
            sink_pages=sparse.sink_pages, local_pages=sparse.local_pages,
            block_q=sparse.prefill_block_q,
            topk_scale=sparse.prefill_topk_scale,
            n_valid=n_valid, chunk_offset=chunk_offset,
        )

    def causal_attention(self, q, k, v, q_offset: int = 0, k_len=None):
        """Dense causal attention of dense prefill: q ``[B, Hq, Sq, D]`` at
        positions ``q_offset + i`` over the keys ``[0, k_len)`` of k/v
        (dense ``[B, Hkv, Sk, D]`` or paged; ``k_len`` an int or ``[B]``;
        None for a whole prompt: offset 0, keys ``[0, Sq)``) ->
        ``[B, Hq, Sq, D]``.  The kernel backend launches
        ``flash_attention``.  The plain one runs what JAX runs there: its
        chunked online softmax over a whole prompt, the masked dense chunk
        (the flash kernel's plain version) otherwise."""
        from repro_torch.kernels import ops
        from repro_torch.models.layers import attn_chunk, chunked_causal_attention

        kd, vd = as_dense(k), as_dense(v)
        Sq = q.shape[2]
        if k_len is None:
            q_offset, k_len = 0, Sq
            # JAX's chunk; one under 64 (a length with no divisor near 512)
            # would loop over up to Sq^2 / 2 chunk pairs in Python, so such
            # a prompt takes the masked form
            if self.plain and attn_chunk(Sq) >= 64:
                return chunked_causal_attention(q, kd[:, :, :Sq], vd[:, :, :Sq],
                                                chunk=attn_chunk(Sq))
        fn = ops.flash_attention_reference if self.plain else ops.flash_attention
        return fn(q, kd, vd, True, q_offset, k_len)

    def full_page_table(self, k, seq_len):
        """(identity page table ``[B, n_kv, n_pages]`` int32, page valid
        while it holds a position ``< seq_len``) of paged k, for
        :meth:`dense_decode`'s kernel; None on the plain backend."""
        if self.plain:
            return None
        B, n_kv, n_pages, ps = k.shape[:4]
        pages = torch.arange(n_pages, dtype=torch.int32, device=k.device)
        table = pages.expand(B, n_kv, n_pages).contiguous()
        valid = (pages * ps)[None, :] < seq_len.to(torch.int32)[:, None]
        return table, valid[:, None].expand(B, n_kv, n_pages).contiguous()

    def dense_decode(self, q, k, v, seq_len, page_size: int, table=None,
                     shard=None):
        """Full-attention decode: q ``[B, n_q, D]`` over every key of k/v
        (paged or dense) at a position ``< seq_len`` (all when None) ->
        ``[B, n_q, D]``.  The kernel backend runs the paged-attention kernel
        over the identity page table (``table``, from
        :meth:`full_page_table` once per decode step; built here when
        None); the plain one the oracle :func:`dense_decode_attention`."""
        if self.plain:
            return dense_decode_attention(q, as_dense(k), as_dense(v), seq_len)
        kp, vp = as_paged(k, page_size), as_paged(v, page_size)
        if seq_len is None:
            seq_len = torch.full((q.shape[0],), kp.shape[2] * page_size,
                                 dtype=torch.int32, device=q.device)
        if table is None:
            table = self.full_page_table(kp, seq_len)
        return self.attend(q, kp, vp, *table, page_size, seq_len, shard)

    def scores(self, rq, store: CentroidStore, la, n_kv: int) -> torch.Tensor:
        """Estimation: rank queries ``[B, n_q, Dp]`` + store -> block
        scores ``[B, n_kv, max_blocks]`` (``NEG_INF`` pads)."""
        from repro_torch.kernels import ops

        fn = ops.centroid_scores_reference if self.plain else ops.centroid_scores
        return fn(rq, store, la, n_kv)

    def attend(self, q, k, v, page_table, page_valid, page_size: int,
               seq_len, shard=None) -> torch.Tensor:
        """Attention over the selected pages -> ``[B, n_q, D]``."""
        from repro_torch.kernels import ops

        fn = (ops.paged_attention_reference if self.plain else functools.partial(
            ops.paged_attention,
            n_split=decode_split(shard, page_table.shape[-1], q.device)))
        return fn(q, k, v, page_table, page_valid, page_size, seq_len)

    def decode(self, q, k, v, store, la, sparse, seq_len, collect_tel=False,
               page_table=None, shard=None):
        """Score -> top-K_h -> attend -> (out [B, n_q, D],
        page_table [B, H, P_sel], page_valid [B, H, P_sel]); with
        ``collect_tel`` also the ``[B, 4]`` sparsity counters
        (:func:`selection_telemetry`) of the selection just made.
        ``page_table`` is read only by a backend that attends a fixed table
        (``"dense"``: :meth:`full_page_table`, built once per decode step);
        a sparse backend selects its own.

        The kernel backend with ``sparse.fused_decode`` runs the fused
        kernel (slots in ascending block order); otherwise, and always on
        the reference backend, the staged pipeline runs (slots in rank
        order).  The fused kernel keeps its scores on chip, so its counters
        come from one more :meth:`scores` call and :func:`rank_blocks`."""
        from repro_torch.kernels import ops

        rq = rank_query(q, sparse.centroid_method, q.shape[-1])
        n_kv = k.shape[1]
        sink, local = sparse.sink_pages, sparse.local_pages
        if sparse.fused_decode and not self.plain:
            out, table, valid = ops.fused_decode(
                q, rq, k, v, store, la, sink, local, seq_len,
                n_split=decode_split(shard, la.selected_pages, q.device))
            if not collect_tel:
                return out, table, valid
            scores = self.scores(rq, store, la, n_kv)
            return out, table, valid, selection_telemetry(
                scores, la, seq_len, sink, local)
        scores = self.scores(rq, store, la, n_kv)
        ranked = rank_blocks(scores, la, seq_len, sink, local)
        table, valid = select_page_table(scores, la, seq_len, sink, local,
                                         ranked=ranked)
        out = self.attend(q, k, v, table, valid, la.page_size, seq_len, shard)
        if not collect_tel:
            return out, table, valid
        return out, table, valid, selection_telemetry(
            scores, la, seq_len, sink, local, ranked=ranked)


class ReferenceBackend(AttentionBackend):
    name = "reference"
    plain = True

    def _pool_rank_keys(self, keys, layout, method):
        from repro_torch.kernels.block_centroid import pool_rank_keys_plain

        return [pool_rank_keys_plain(keys[:, h:h + 1], b, method)[:, 0]
                for h, b in enumerate(layout.block_sizes)]


class CudaBackend(AttentionBackend):
    name = "cuda"
    plain = False

    def _pool_rank_keys(self, keys, layout, method):
        """Heads grouped by block size: one kernel launch per distinct size."""
        from repro_torch.kernels.block_centroid import pool_rank_keys

        groups: Dict[int, List[int]] = {}
        for h, b in enumerate(layout.block_sizes):
            groups.setdefault(b, []).append(h)
        per_head: List[Optional[torch.Tensor]] = [None] * layout.n_heads
        for bsz, heads in sorted(groups.items()):
            sub = keys if len(heads) == keys.shape[1] else keys[:, heads]
            pooled = pool_rank_keys(sub.contiguous(), bsz, method)
            for i, h in enumerate(heads):
                per_head[h] = pooled[:, i]
        return per_head


_REGISTRY: Dict[str, AttentionBackend] = {}


def register_backend(backend: AttentionBackend) -> AttentionBackend:
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> AttentionBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown attention backend {name!r}; available: "
            f"{available_backends()}"
        ) from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_backend(ReferenceBackend())
register_backend(CudaBackend())
