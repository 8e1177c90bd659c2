"""Exact K_h-th largest score per (sequence, head), plus the count of scores
strictly above it.

:func:`topk_threshold` is the wrapper of the hand-written CUDA kernel
``csrc/topk_threshold.cu`` (the port of ``repro/kernels/topk_threshold.py``),
which runs the fused decode kernel's own threshold search.  On CUDA tensors
it launches the kernel or raises; only for tensors on the CPU does it run
:func:`topk_threshold_plain`, the plain PyTorch version
(:func:`repro_torch.kernels.ref.topk_threshold_ref`).

``launches`` counts kernel launches and ``plain_calls`` calls of the plain
version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import expect

launches = 0
plain_calls = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 3 + [_P]


def reset_counts():
    global launches, plain_calls
    launches = plain_calls = 0


def topk_threshold(scores: torch.Tensor, k_per_head):
    """scores ``[B, H, M]`` f32 (pads at -inf or -1e30), ``k_per_head``
    ``[H]`` with ``1 <= K_h <= M`` (checked when given on the host) ->
    (threshold ``[B, H]`` f32, count_gt ``[B, H]`` int32).  On a fake or
    meta tensor: the abstract rule (``_build``)."""
    B, H, M = scores.shape
    if not torch.is_tensor(k_per_head):
        ks = np.asarray(k_per_head)
        if ks.shape != (H,) or not ((ks >= 1) & (ks <= M)).all():
            raise ValueError(f"k_per_head {ks} must hold {H} values in [1, {M}]")
    abstract = _build.is_abstract(scores)
    if scores.device.type == "cpu" and not abstract:
        k = torch.as_tensor(k_per_head, dtype=torch.int32, device=scores.device)
        return topk_threshold_plain(scores, k)
    global launches
    dev = scores.device
    expect(scores, torch.float32, (B, H, M), dev, "scores")
    if torch.is_tensor(k_per_head) and k_per_head.numel() != H:
        raise ValueError(f"k_per_head has {k_per_head.numel()} values, not {H}")
    if abstract:
        return (scores.new_empty((B, H)),
                scores.new_empty((B, H), dtype=torch.int32))
    k = torch.as_tensor(k_per_head, dtype=torch.int32, device=dev).reshape(H).contiguous()
    lib = _build.load("topk_threshold")
    fn = _launcher(lib)
    _build.check_smem(lib.topk_threshold_smem_bytes(M), "topk_threshold")
    thr = torch.empty((B, H), dtype=torch.float32, device=dev)
    cnt = torch.empty((B, H), dtype=torch.int32, device=dev)
    rc = fn(scores.data_ptr(), k.data_ptr(), thr.data_ptr(), cnt.data_ptr(),
            B, H, M, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "topk_threshold")
    launches += 1
    return thr, cnt


def topk_threshold_plain(scores, k_per_head):
    """Plain PyTorch version of :func:`topk_threshold` (same outputs)."""
    global plain_calls
    plain_calls += 1
    return ref.topk_threshold_ref(scores, k_per_head)


def _launcher(lib):
    fn = lib.topk_threshold_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.topk_threshold_smem_bytes.argtypes = [_I]
        lib.topk_threshold_smem_bytes.restype = ctypes.c_size_t
    return fn
