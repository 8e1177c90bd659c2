"""Full-attention backend ``"dense"`` (counterpart of ``repro.backends.dense``),
the paper's Full Attention baseline.

It keeps the store structure of the sparse backends (the model builds and
refreshes the decode store as for them) but attends over the whole live
context and never reads the store: ``append`` is a no-op, ``decode``
attends every live token and ``prefill_attention`` every query's whole
causal prefix.  On CUDA tensors it launches the hand-written kernels:
decode runs ``paged_attention`` over the identity page table, prefill
``flash_attention`` with the chunk's offset and live length (their plain
versions on CPU tensors).  ``DenseBackend(plain=True)`` runs the plain
oracles instead: :func:`~repro_torch.core.sparse_attention.
dense_decode_attention` and :func:`~repro_torch.models.layers.
chunked_causal_attention` (or the flash kernel's plain version for a
chunk).
"""
from __future__ import annotations

from repro_torch.backends.base import CudaBackend, ReferenceBackend


class DenseBackend(CudaBackend):
    name = "dense"
    full_attention = True

    def __init__(self, plain: bool = False):
        self.plain = plain

    def _pool_rank_keys(self, keys, layout, method):
        if self.plain:
            return ReferenceBackend._pool_rank_keys(self, keys, layout, method)
        return super()._pool_rank_keys(keys, layout, method)

    def append(self, store, k_cache, la, seq_len, sparse):
        # centroids are never read on the dense path
        return store

    def decode(self, q, k, v, store, la, sparse, seq_len=None,
               collect_tel=False, page_table=None, shard=None):
        """-> (out ``[B, n_q, D]``, None, None), plus None for the counters
        with ``collect_tel`` (no selection on the dense path).
        ``page_table``: the step's identity table (:meth:`full_page_table`),
        built here when None."""
        out = self.dense_decode(q, k, v, seq_len, sparse.page_size, page_table,
                                shard=shard)
        return (out, None, None, None) if collect_tel else (out, None, None)

    def prefill_attention(self, q, k, v, score_store, la, sparse,
                          n_valid=None, chunk_offset: int = 0, shard=None):
        """Every query attends its whole causal prefix among the first
        ``n_valid`` keys (default ``chunk_offset + Sq``) -> (out, None)."""
        if n_valid is None:
            n_valid = chunk_offset + q.shape[2]
        return self.causal_attention(q, k, v, chunk_offset, n_valid), None
