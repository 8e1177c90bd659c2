"""Attention backend registry of the port: ``"reference"`` (plain PyTorch),
``"cuda"`` (hand-written Hopper kernels) and ``"dense"`` (the Full
Attention baseline, on the same kernels)."""
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
from repro_torch.backends.dense import DenseBackend

register_backend(DenseBackend())

__all__ = [
    "AttentionBackend",
    "AttentionPlan",
    "CentroidStore",
    "CudaBackend",
    "DenseBackend",
    "ReferenceBackend",
    "build_plan",
    "get_backend",
    "register_backend",
]
