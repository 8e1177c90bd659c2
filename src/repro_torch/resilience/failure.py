"""Failure-domain records: checkpoints and structured failure reasons (a
copy of ``repro.resilience.failure``).

The engine snapshots a :class:`Checkpoint` per sequence on admission and
every ``ResilienceConfig.checkpoint_interval`` committed tokens.  A
checkpoint is O(1): because sampling is keyed by ``(seq_id, position)``
and the recompute-style resume rebuilds KV byte-identically, the only
durable state a restore needs is the committed-output watermark — page
bytes never have to be copied.  Restoring truncates the output to the
watermark and re-queues the request; every truncated token regenerates
identically on re-admission.

A request that exhausts its failure budget retires as FAILED carrying a
:class:`FailureInfo` (reason / detail / tick / retries) on
``Request.failure`` instead of poisoning the tick loop.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict

#: structured failure reasons (``Request.failure["reason"]`` /
#: ``ServingMetrics.snapshot()["failed_by_reason"]`` keys).
FAIL_DEVICE = "device_error"
FAIL_SAMPLER = "sampler_anomaly"
FAIL_HOST_IO = "host_io"


@dataclass
class Checkpoint:
    """Per-sequence restore point (committed-output watermark)."""

    n_output: int    #: committed output tokens at snapshot time
    n_pages: int     #: pages held at snapshot time (diagnostics only)
    tick: int        #: engine tick the snapshot was taken


@dataclass
class FailureInfo:
    """Why a request retired as FAILED."""

    reason: str      #: one of the FAIL_* constants
    detail: str      #: str(exc) of the final fault
    tick: int        #: tick of the budget-exhausting fault
    retries: int     #: retries consumed (== failure budget + 1 fault)

    def as_dict(self) -> Dict:
        return asdict(self)
