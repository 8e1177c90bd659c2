"""Analytic cost model for the AB-Sparse attention kernels (counterpart of
``repro.obs.cost``).

Per-kernel-launch FLOPs, HBM bytes and the realized sparsity fraction,
derived from the config (block budgets, head dims, INT4 store layout),
specialized to a single attention launch so a roofline table can report
where each kernel sits against the dense equivalent.

All byte counts assume bf16 KV (2 B/elem) and the INT4 centroid store
(hd bytes per block row: 2*hd channels at 4 bits).
"""
from __future__ import annotations

from typing import Dict


def decode_kernel_cost(cfg, context_len: int, batch: int = 1) -> Dict[str, float]:
    """Cost of one sparse decode attention launch over all attn layers.

    FLOPs: block scoring (2*B*Hq*total_blocks*2hd against the INT4 store)
    plus sparse attention over the selected budget (QK^T + PV = 4*B*Hq*
    budget*hd).  Bytes: store read + selected KV read + one-token KV write.
    """
    hd = cfg.resolved_head_dim
    n_attn = len(cfg.attn_layers)
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    budget = cfg.sparse.budget_for(context_len)
    n_blocks = sum(
        context_len // b for b in cfg.sparse.layer_block_sizes(0, n_kv)
    )
    score_flops = n_attn * 2.0 * batch * n_q * n_blocks * 2 * hd
    attn_flops = n_attn * 4.0 * batch * n_q * budget * hd
    dense_flops = n_attn * 4.0 * batch * n_q * context_len * hd

    store_bytes = n_attn * batch * n_blocks * hd * 1.0
    kv_read = n_attn * batch * n_kv * budget * hd * 2 * 2.0
    kv_write = n_attn * batch * n_kv * hd * 2 * 2.0
    dense_read = n_attn * batch * n_kv * context_len * hd * 2 * 2.0

    sparsity = min(budget / context_len, 1.0) if context_len else 1.0
    return {
        "kind": "decode",
        "context_len": float(context_len),
        "batch": float(batch),
        "flops": score_flops + attn_flops,
        "hbm_bytes": store_bytes + kv_read + kv_write,
        "dense_flops": dense_flops,
        "dense_hbm_bytes": dense_read + kv_write,
        "realized_sparsity_frac": sparsity,
        "flops_vs_dense": (score_flops + attn_flops) / dense_flops
        if dense_flops else 0.0,
        "bytes_vs_dense": (store_bytes + kv_read + kv_write)
        / (dense_read + kv_write) if dense_read else 0.0,
    }


def prefill_kernel_cost(
    cfg, context_len: int, chunk_tokens: int, batch: int = 1
) -> Dict[str, float]:
    """Cost of one sparse prefill chunk launch over all attn layers.

    Each of the chunk's query tokens attends a budget capped at
    ``budget_for(context_len)`` (plus causal truncation); dense equivalent
    attends the full prefix.  Bytes: selected KV + chunk KV write.
    """
    hd = cfg.resolved_head_dim
    n_attn = len(cfg.attn_layers)
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    budget = min(cfg.sparse.budget_for(context_len), context_len)
    avg_prefix = max(context_len - chunk_tokens / 2.0, 1.0)
    attended = min(budget, avg_prefix)

    flops = n_attn * 4.0 * batch * n_q * chunk_tokens * attended * hd
    dense_flops = n_attn * 4.0 * batch * n_q * chunk_tokens * avg_prefix * hd
    kv_read = n_attn * batch * n_kv * attended * hd * 2 * 2.0
    kv_write = n_attn * batch * n_kv * chunk_tokens * hd * 2 * 2.0
    dense_read = n_attn * batch * n_kv * avg_prefix * hd * 2 * 2.0

    return {
        "kind": "prefill",
        "context_len": float(context_len),
        "chunk_tokens": float(chunk_tokens),
        "batch": float(batch),
        "flops": flops,
        "hbm_bytes": kv_read + kv_write,
        "dense_flops": dense_flops,
        "dense_hbm_bytes": dense_read + kv_write,
        "realized_sparsity_frac": attended / avg_prefix,
        "flops_vs_dense": flops / dense_flops if dense_flops else 0.0,
        "bytes_vs_dense": (kv_read + kv_write) / (dense_read + kv_write)
        if dense_read else 0.0,
    }
