"""Dense GQA flash attention, causal or not (the dense-prefill baseline).

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
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_F, _P]
#: keys per tile of the kernel: S must be a multiple of it (a block's 128
#: query rows need not divide S)
TILE = 64


def reset_counts():
    global launches, plain_calls
    launches = plain_calls = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q ``[B, Hq, S, D]``, k/v ``[B, Hkv, S, D]`` -> ``[B, Hq, S, D]`` in
    q's dtype (bf16 on the card)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    global launches
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    dev = q.device
    expect(q, torch.bfloat16, (B, Hq, S, D), dev, "q")
    expect(k, torch.bfloat16, (B, Hkv, S, D), dev, "k")
    expect(v, torch.bfloat16, (B, Hkv, S, D), dev, "v")
    if D not in (64, 128) or Hq % Hkv or S % TILE:
        raise ValueError(
            f"flash_attention kernel takes head_dim 64/128, Hq a multiple of "
            f"Hkv and S a multiple of {TILE} (got D={D}, Hq={Hq}, Hkv={Hkv}, S={S})"
        )
    out = torch.empty_like(q)
    fn = _launcher(_build.load("flash_attention"))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, S, D, int(causal), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_attention")
    launches += 1
    return out


def flash_attention_plain(q, k, v, causal=True):
    """Plain PyTorch version of :func:`flash_attention` (same outputs)."""
    global plain_calls
    plain_calls += 1
    return ref.flash_attention_ref(q, k, v, causal)


def _launcher(lib):
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn
