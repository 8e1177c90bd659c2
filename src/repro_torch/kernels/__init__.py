"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``fused_decode``, ``sparse_prefill``, ``centroid_score`` (the wrappers
``centroid_scores_quantized`` and ``centroid_scores_f32``) and
``paged_attention`` wrap CUDA kernels built from ``repro_torch/csrc`` at
first use (see :mod:`repro_torch.kernels._build`).
"""
from repro_torch.kernels import centroid_score, fused_decode, paged_attention, sparse_prefill

_SINGLE = (fused_decode, sparse_prefill, paged_attention)


def reset_counts():
    """Zero every kernel's launch and plain-call counters."""
    for m in (*_SINGLE, centroid_score):
        m.reset_counts()


def counts():
    """-> {kernel: {"launches": n, "plain_calls": m}}, one entry per wrapper."""
    out = {
        m.__name__.rsplit(".", 1)[-1]: {
            "launches": m.launches, "plain_calls": m.plain_calls,
        }
        for m in _SINGLE
    }
    for name in centroid_score.NAMES:
        out[name] = {"launches": centroid_score.launches[name],
                     "plain_calls": centroid_score.plain_calls[name]}
    return out
