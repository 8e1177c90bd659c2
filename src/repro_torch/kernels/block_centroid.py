"""Block rank-key pooling: raw keys -> per-block rank keys for one block size.

:func:`pool_rank_keys` is the wrapper of the hand-written CUDA kernel
``csrc/pool_rank_keys.cu`` (the port of ``repro/kernels/block_centroid.py``).
On CUDA tensors it launches the kernel or raises; only for tensors on the
CPU does it run :func:`pool_rank_keys_plain`, the plain PyTorch version
(:func:`repro_torch.kernels.ref.pool_rank_keys_ref`).  The TPU kernel's
``chunk`` (tokens per sequential grid step) has no counterpart here.

The kernel treats the ``B * Hg * S / block_size`` rank keys as one flat
list; :func:`pool_plan` says how a launch cuts it (``D / 8`` threads per
key, each owning 8 consecutive channels, ``256 * 8 / D`` keys per thread
block).

``launches`` counts kernel launches and ``plain_calls`` calls of the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.centroids import METHODS, padded_rank_key_width
from repro_torch.kernels import _build, ref

launches = 0
plain_calls = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 2 + [_I] * 8 + [_P]
_DTYPES = (torch.float32, torch.bfloat16)
#: threads per thread block and channels per thread of ``pool_rank_keys.cu``
NT, VEC = 256, 8


def reset_counts():
    global launches, plain_calls
    launches = plain_calls = 0


def pool_plan(n_rows: int, seq_len: int, head_dim: int, block_size: int) -> dict:
    """How one launch covers ``n_rows`` (sequence, head) rows of
    ``seq_len`` tokens: ``{"n_keys", "lanes" (threads per rank key),
    "keys_per_cta", "grid" (thread blocks)}``.  Raises for a head_dim the
    kernel does not take (8 channels per thread, ``D / 8`` a power of two
    up to 32: D in 8, 16, ..., 256)."""
    D = head_dim
    lanes = D // VEC
    if D % VEC or not 1 <= lanes <= 32 or lanes & (lanes - 1):
        raise ValueError(f"pool_rank_keys kernel takes head_dim 8, 16, 32, 64, "
                         f"128 or 256, got {D}")
    n_keys = n_rows * (seq_len // block_size)
    per_cta = NT // lanes
    return {"n_keys": n_keys, "lanes": lanes, "keys_per_cta": per_cta,
            "grid": -(-n_keys // per_cta)}


def pool_rank_keys(keys: torch.Tensor, block_size: int, method: str) -> torch.Tensor:
    """keys ``[B, Hg, S, D]`` (f32 or bf16) -> lane-padded f32 rank keys
    ``[B, Hg, S / block_size, Dp]``: mean, quest [max, min] or arkvale
    [center, radius], zeros in the pad lanes."""
    if method not in METHODS:
        raise ValueError(f"unknown centroid method {method!r}")
    B, Hg, S, D = keys.shape
    if S % block_size:
        raise ValueError(f"pool_rank_keys: sequence length {S} is not a "
                         f"multiple of the block size {block_size}")
    if keys.device.type == "cpu":
        return pool_rank_keys_plain(keys, block_size, method)
    global launches
    if keys.dtype not in _DTYPES:
        raise TypeError(f"pool_rank_keys kernel takes f32 or bf16 keys, got {keys.dtype}")
    if not keys.is_contiguous() or keys.data_ptr() % 16:
        raise ValueError("keys must be contiguous and 16-byte aligned")
    plan = pool_plan(B * Hg, S, D, block_size)
    Dp = padded_rank_key_width(D, method)
    out = torch.empty((B, Hg, S // block_size, Dp), dtype=torch.float32,
                      device=keys.device)
    fn = _launcher(_build.load("pool_rank_keys"))
    rc = fn(keys.data_ptr(), out.data_ptr(), B * Hg, S, D, block_size, Dp,
            METHODS.index(method), plan["keys_per_cta"],
            int(keys.dtype == torch.bfloat16),
            torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(rc, "pool_rank_keys")
    launches += 1
    return out


def pool_rank_keys_plain(keys, block_size, method):
    """Plain PyTorch version of :func:`pool_rank_keys` (same outputs)."""
    global plain_calls
    plain_calls += 1
    return ref.pool_rank_keys_ref(keys, block_size, method)


def _launcher(lib):
    fn = lib.pool_rank_keys_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn
