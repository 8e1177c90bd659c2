"""Attention backend registry of the port: ``"reference"`` (plain PyTorch)
and ``"cuda"`` (hand-written Hopper kernels)."""
from repro_torch.backends.base import (
    AttentionBackend,
    AttentionPlan,
    CentroidStore,
    CudaBackend,
    ReferenceBackend,
    build_plan,
    get_backend,
    register_backend,
)

__all__ = [
    "AttentionBackend",
    "AttentionPlan",
    "CentroidStore",
    "CudaBackend",
    "ReferenceBackend",
    "build_plan",
    "get_backend",
    "register_backend",
]
