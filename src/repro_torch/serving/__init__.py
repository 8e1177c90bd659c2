"""Serving stack of the port: engine, scheduler, sampler, metrics."""
from repro_torch.serving.engine import Engine, EngineStalled
from repro_torch.serving.scheduler import Request

__all__ = ["Engine", "EngineStalled", "Request"]
