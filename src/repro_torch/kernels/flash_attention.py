"""Dense GQA flash attention, causal or not: dense prefill, chunked or
single-shot (queries at an offset over a prefix of the keys), and the
dense-prefill baseline.

:func:`flash_attention` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu`` (the port of ``repro/kernels/flash_attention.py``).
On CUDA tensors it launches the kernel or raises; only for tensors on the
CPU does it run :func:`flash_attention_plain`, the plain PyTorch version
(:func:`repro_torch.kernels.ref.flash_attention_ref`).

``launches`` counts kernel launches and ``plain_calls`` calls of the plain
version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import expect

launches = 0
plain_calls = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 5 + [_I] * 9 + [_F, _P]


def reset_counts():
    global launches, plain_calls
    launches = plain_calls = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    k_len=None) -> torch.Tensor:
    """q ``[B, Hq, Sq, D]`` at positions ``q_offset + i``, k/v
    ``[B, Hkv, Sk, D]`` -> ``[B, Hq, Sq, D]`` in q's dtype (bf16 on the
    card).  Key j is attended when ``j < k_len`` and, if ``causal``,
    ``j <= q_offset + i``.  ``k_len``: None (all Sk keys), an int, or an
    int32 tensor ``[B]``; each in ``[1, Sk]``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, q_offset, k_len)
    global launches
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dev = q.device
    expect(q, torch.bfloat16, (B, Hq, Sq, D), dev, "q")
    expect(k, torch.bfloat16, (B, Hkv, Sk, D), dev, "k")
    expect(v, torch.bfloat16, (B, Hkv, Sk, D), dev, "v")
    if D not in (64, 128) or Hq % Hkv:
        raise ValueError(
            f"flash_attention kernel takes head_dim 64/128 and Hq a multiple "
            f"of Hkv (got D={D}, Hq={Hq}, Hkv={Hkv})"
        )
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    k_ptr, k_all = None, Sk
    if isinstance(k_len, torch.Tensor):
        expect(k_len, torch.int32, (B,), dev, "k_len")
        k_ptr, k_all = k_len.data_ptr(), 0
    elif k_len is not None:
        k_all = int(k_len)
        if not 1 <= k_all <= Sk:
            raise ValueError(f"flash_attention: k_len {k_all} not in [1, {Sk}]")
    out = torch.empty_like(q)
    fn = _launcher(_build.load("flash_attention"))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), k_ptr,
            k_all, B, Hq, Hkv, Sq, Sk, D, int(q_offset), int(causal),
            1.0 / math.sqrt(D), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_attention")
    launches += 1
    return out


def flash_attention_plain(q, k, v, causal=True, q_offset=0, k_len=None):
    """Plain PyTorch version of :func:`flash_attention` (same outputs)."""
    global plain_calls
    plain_calls += 1
    return ref.flash_attention_ref(q, k, v, causal, q_offset, k_len)


def _launcher(lib):
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn
