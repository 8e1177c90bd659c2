"""Observability: execution tracing, sparsity telemetry, kernel cost model."""
from repro_torch.obs.cost import decode_kernel_cost, prefill_kernel_cost
from repro_torch.obs.telemetry import (
    BLOCKS,
    BUDGET,
    FORCED,
    N_COUNTERS,
    PAGES,
    SparsityAggregate,
    prefill_block_candidates,
)
from repro_torch.obs.trace import (
    PID_ENGINE,
    PID_KERNEL,
    PID_MEMORY,
    PID_SCHED,
    PID_SEQ,
    TraceEvent,
    TraceRecorder,
)
from repro_torch.obs.validate import validate_chrome_trace

__all__ = [
    "TraceRecorder",
    "TraceEvent",
    "PID_SCHED",
    "PID_ENGINE",
    "PID_MEMORY",
    "PID_SEQ",
    "PID_KERNEL",
    "SparsityAggregate",
    "prefill_block_candidates",
    "BLOCKS",
    "PAGES",
    "FORCED",
    "BUDGET",
    "N_COUNTERS",
    "decode_kernel_cost",
    "prefill_kernel_cost",
    "validate_chrome_trace",
]
