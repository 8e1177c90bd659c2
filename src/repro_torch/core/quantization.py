"""Centroid-store quantization (counterpart of ``repro.core.quantization``).

Codes are byte-identical to the JAX package: ``torch.round`` and
``jnp.round`` both round half to even, and the encode keeps the
``(x - zero) / scale`` order.  INT4 codes use the split-half packing the
kernels read: byte ``j`` holds channels ``(j, j + W/2)`` as (low, high)
nibbles.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_SCHEMES = {
    "int8_asym": (8, False),
    "int8_sym": (8, True),
    "int4_asym": (4, False),
    "int4_sym": (4, True),
    "int2_asym": (2, False),
    "int2_sym": (2, True),
}


def store_bits(scheme: Optional[str]) -> int:
    """Bit width of the centroid-store codes; 0 == unquantized f32."""
    if scheme in (None, "none"):
        return 0
    return _SCHEMES[scheme][0]


def store_symmetric(scheme: Optional[str]) -> bool:
    if scheme in (None, "none"):
        return False
    return _SCHEMES[scheme][1]


def code_max(bits: int, symmetric: bool) -> float:
    if symmetric:
        return 2.0 ** (bits - 1) - 1.0
    return 2.0**bits - 1.0


def affine_params_from_minmax(
    xmin: torch.Tensor, xmax: torch.Tensor, bits: int, symmetric: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero) from min/max statistics."""
    qhi = code_max(bits, symmetric)
    if symmetric:
        amax = torch.maximum(xmin.abs(), xmax.abs())
        scale = torch.clamp_min(amax / qhi, 1e-8)
        zero = torch.zeros_like(scale)
    else:
        scale = torch.clamp_min((xmax - xmin) / qhi, 1e-8)
        zero = xmin
    return scale, zero


def encode_affine(
    x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor, bits: int,
    symmetric: bool,
) -> torch.Tensor:
    """f32 -> unpacked uint8 codes under frozen (scale, zero)."""
    qhi = code_max(bits, symmetric)
    if symmetric:
        q = torch.clamp(torch.round(x / scale) + qhi, 0, 2 * qhi)
    else:
        q = torch.clamp(torch.round((x - zero) / scale), 0, qhi)
    return q.to(torch.uint8)


def decode_affine(
    codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor, bits: int,
    symmetric: bool,
) -> torch.Tensor:
    """Unpacked uint8 codes -> f32 (the formula the kernels fuse)."""
    c = codes.to(torch.float32)
    if symmetric:
        return (c - code_max(bits, symmetric)) * scale
    return c * scale + zero


def pack_split_half(codes: torch.Tensor) -> torch.Tensor:
    W = codes.shape[-1]
    assert W % 2 == 0, W
    lo = codes[..., : W // 2].to(torch.uint8)
    hi = codes[..., W // 2:].to(torch.uint8)
    return lo | (hi << 4)


def unpack_split_half(packed: torch.Tensor) -> torch.Tensor:
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    return torch.cat([lo, hi], dim=-1)
