"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``fused_decode``, ``sparse_prefill``, ``centroid_score`` (the wrappers
``centroid_scores_quantized`` and ``centroid_scores_f32``),
``paged_attention``, ``pool_rank_keys`` (module ``block_centroid``),
``topk_threshold`` and ``flash_attention`` wrap CUDA kernels built from
``repro_torch/csrc`` at first use (see :mod:`repro_torch.kernels._build`).
"""
from repro_torch.kernels import (
    block_centroid,
    centroid_score,
    flash_attention,
    fused_decode,
    paged_attention,
    sparse_prefill,
    topk_threshold,
)

#: wrapper name -> module of the kernels with one wrapper each
_SINGLE = {
    "fused_decode": fused_decode,
    "sparse_prefill": sparse_prefill,
    "paged_attention": paged_attention,
    "pool_rank_keys": block_centroid,
    "topk_threshold": topk_threshold,
    "flash_attention": flash_attention,
}


def reset_counts():
    """Zero every kernel's launch and plain-call counters."""
    for m in (*_SINGLE.values(), centroid_score):
        m.reset_counts()


def counts():
    """-> {kernel: {"launches": n, "plain_calls": m}}, one entry per wrapper.

    ``launches`` counts kernel launches executed, those inside a replayed
    CUDA graph included: a replay runs no Python, so the graph's owner adds
    its captured step's counts per replay (:func:`add_counts`, done by
    :class:`repro_torch.serving.graphs.DecodeGraph`)."""
    out = {name: {"launches": m.launches, "plain_calls": m.plain_calls}
           for name, m in _SINGLE.items()}
    for name in centroid_score.NAMES:
        out[name] = {"launches": centroid_score.launches[name],
                     "plain_calls": centroid_score.plain_calls[name]}
    return out


def add_counts(delta):
    """Add ``delta`` ({kernel: {"launches": n, "plain_calls": m}}, as
    :func:`counts` gives it; kernels left out add nothing) to the counters."""
    for name, d in delta.items():
        if name in _SINGLE:
            m = _SINGLE[name]
            m.launches += d["launches"]
            m.plain_calls += d["plain_calls"]
        else:
            centroid_score.launches[name] += d["launches"]
            centroid_score.plain_calls[name] += d["plain_calls"]
