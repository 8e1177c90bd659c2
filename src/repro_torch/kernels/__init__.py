"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``fused_decode`` and ``sparse_prefill`` wrap CUDA kernels built from
``repro_torch/csrc`` at first use (see :mod:`repro_torch.kernels._build`).
"""
from repro_torch.kernels import fused_decode, sparse_prefill


def reset_counts():
    """Zero every kernel's launch and plain-call counters."""
    fused_decode.reset_counts()
    sparse_prefill.reset_counts()


def counts():
    """-> {kernel: {"launches": n, "plain_calls": m}}."""
    return {
        m.__name__.rsplit(".", 1)[-1]: {
            "launches": m.launches, "plain_calls": m.plain_calls,
        }
        for m in (fused_decode, sparse_prefill)
    }
