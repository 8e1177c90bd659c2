"""Staged AB-Sparse estimation: every centroid store row scored against its
head's GQA rank-query group, max over the group.

:func:`centroid_scores_quantized` (INT4 split-half / INT8 affine store) and
:func:`centroid_scores_f32` (unquantized f32 store) wrap the hand-written
CUDA kernel ``csrc/centroid_score.cu``, the port of
``repro/kernels/centroid_score.py``.  On CUDA tensors they launch the kernel
or raise; only for tensors on the CPU do they run
:func:`centroid_scores_plain`, the plain PyTorch version
(:func:`repro_torch.kernels.ref.centroid_scores_ref`).

``launches`` and ``plain_calls`` count, per wrapper name, kernel launches
and calls of the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import expect

NAMES = ("centroid_scores_quantized", "centroid_scores_f32")
launches = dict.fromkeys(NAMES, 0)
plain_calls = dict.fromkeys(NAMES, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 9 + [_P]


def reset_counts():
    for name in NAMES:
        launches[name] = plain_calls[name] = 0


def centroid_scores_quantized(
    rq: torch.Tensor,              # [B, n_kv * g, Dp] f32 rank queries
    codes: torch.Tensor,           # [B, total_rows, Dp // 2] (INT4) / Dp (INT8) u8
    scale: torch.Tensor,           # [B, n_kv, Dp] f32 per-(sequence, head, channel)
    zero: torch.Tensor,
    tile_head: torch.Tensor,       # [n_tiles] int32 tile -> head
    tile_rows: int,
    *,
    bits: int,
    symmetric: bool,
) -> torch.Tensor:
    """-> flat scores ``[B, total_rows]`` f32 (max over the GQA group)."""
    if bits not in (4, 8):
        raise ValueError(f"centroid_scores_quantized takes 4/8-bit codes, got {bits}")
    return _scores("centroid_scores_quantized", rq, codes, scale, zero,
                   tile_head, tile_rows, bits, symmetric)


def centroid_scores_f32(
    rq: torch.Tensor,              # [B, n_kv * g, Dp] f32
    rank_keys: torch.Tensor,       # [B, total_rows, Dp] f32 (unquantized store)
    n_kv: int,
    tile_head: torch.Tensor,       # [n_tiles] int32
    tile_rows: int,
) -> torch.Tensor:
    """-> flat scores ``[B, total_rows]`` f32 (max over the GQA group)."""
    return _scores("centroid_scores_f32", rq, rank_keys, None, None,
                   tile_head, tile_rows, 0, False, n_kv=n_kv)


def _scores(name, rq, codes, scale, zero, tile_head, tile_rows, bits,
            symmetric, n_kv=None):
    abstract = _build.is_abstract(rq, codes, scale, zero, tile_head)
    if rq.device.type == "cpu" and not abstract:
        return centroid_scores_plain(rq, codes, scale, zero, tile_head,
                                     tile_rows, bits=bits, symmetric=symmetric,
                                     n_kv=n_kv)
    B, n_q, Dp = rq.shape
    n_kv = scale.shape[1] if bits else n_kv
    rows = codes.shape[1]
    n_tiles = rows // tile_rows
    dev = rq.device
    cw = Dp // 2 if bits == 4 else Dp
    expect(rq, torch.float32, (B, n_q, Dp), dev, "rq")
    expect(codes, torch.uint8 if bits else torch.float32, (B, rows, cw), dev,
           "codes")
    if bits:
        expect(scale, torch.float32, (B, n_kv, Dp), dev, "scale")
        expect(zero, torch.float32, (B, n_kv, Dp), dev, "zero")
    expect(tile_head, torch.int32, (n_tiles,), dev, "tile_head")
    g = n_q // n_kv
    if n_q % n_kv or not 1 <= g <= 8 or rows % tile_rows:
        raise ValueError(
            f"{name} kernel takes a GQA group <= 8 and whole row tiles (got "
            f"n_q={n_q}, n_kv={n_kv}, rows={rows}, tile_rows={tile_rows})"
        )
    _build.expect_rows(Dp, name, codes=codes, scale=scale, zero=zero)
    if abstract:
        return rq.new_empty((B, rows), dtype=torch.float32)
    out = torch.empty((B, rows), dtype=torch.float32, device=dev)
    lib = _build.load("centroid_score")
    fn = _launcher(lib)
    _build.check_smem(lib.centroid_score_smem_bytes(g, Dp), name)
    rc = fn(
        rq.data_ptr(), codes.data_ptr(),
        scale.data_ptr() if bits else None, zero.data_ptr() if bits else None,
        tile_head.data_ptr(), out.data_ptr(),
        B, n_kv, g, Dp, rows, tile_rows, cw * codes.element_size(), bits,
        int(symmetric), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, name)
    launches[name] += 1
    return out


def centroid_scores_plain(rq, codes, scale, zero, tile_head, tile_rows, *,
                          bits, symmetric, n_kv=None):
    """Plain PyTorch version of both wrappers (same outputs)."""
    plain_calls[NAMES[0] if bits else NAMES[1]] += 1
    return ref.centroid_scores_ref(rq, codes, scale, zero, tile_head,
                                   tile_rows, bits, symmetric, n_kv=n_kv)


def _launcher(lib):
    fn = lib.centroid_score_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.centroid_score_smem_bytes.argtypes = [_I] * 2
        lib.centroid_score_smem_bytes.restype = ctypes.c_size_t
    return fn
