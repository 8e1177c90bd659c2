"""Serving stack of the port: engine, scheduler, async streaming
front-end, sampler, metrics."""
from repro_torch.serving.engine import Engine, EngineStalled
from repro_torch.serving.frontend import AsyncFrontend, TokenStream
from repro_torch.serving.graphs import DecodeGraph, step_graphs_disabled
from repro_torch.serving.metrics import RequestMetrics, ServingMetrics
from repro_torch.serving.scheduler import (
    SLO_BATCH,
    SLO_CLASSES,
    SLO_DEADLINE,
    SLO_INTERACTIVE,
    Request,
    Scheduler,
    SeqState,
)

__all__ = [
    "AsyncFrontend",
    "DecodeGraph",
    "Engine",
    "EngineStalled",
    "Request",
    "RequestMetrics",
    "Scheduler",
    "SeqState",
    "ServingMetrics",
    "SLO_BATCH",
    "SLO_CLASSES",
    "SLO_DEADLINE",
    "SLO_INTERACTIVE",
    "step_graphs_disabled",
    "TokenStream",
]
