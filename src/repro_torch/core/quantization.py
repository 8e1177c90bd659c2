"""Centroid quantization (counterpart of ``repro.core.quantization``).

Codes are byte-identical to the JAX package: ``torch.round`` and
``jnp.round`` both round half to even, and the encode keeps the
``(x - zero) / scale`` order.

Two halves:

- the store path (:func:`affine_params_from_minmax`, :func:`encode_affine`,
  :func:`decode_affine`, :func:`pack_split_half`): INT4 codes in the
  split-half packing the kernels read, byte ``j`` holding channels
  ``(j, j + W/2)`` as (low, high) nibbles;
- the generic API of the paper's §3.3 ablation ladder (INT2 / INT4 / INT8,
  symmetric or asymmetric, per channel or per tensor): :func:`quantize`,
  :func:`dequantize`, :func:`fake_quantize` and :func:`pack_codes`, which
  packs consecutive codes along the last axis (two INT4 or four INT2 a
  byte, low bits first), JAX's packing and not the store's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
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


def scheme_bits(scheme: str) -> int:
    return _SCHEMES[scheme][0]


def scheme_symmetric(scheme: str) -> bool:
    return _SCHEMES[scheme][1]


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


@dataclass(frozen=True)
class QuantizedTensor:
    """Quantized tensor + affine parameters: ``codes`` holds one uint8 code
    a value, or packed bytes along the last axis when ``packed`` (INT4 /
    INT2 only); ``scale`` / ``zero`` (f32) broadcast to ``logical_shape``."""

    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    packed: bool
    symmetric: bool
    logical_shape: Tuple[int, ...]

    @property
    def nbytes_codes(self) -> int:
        return math.prod(self.logical_shape) * self.bits // 8


def _qrange(bits: int, symmetric: bool) -> Tuple[float, float]:
    if symmetric:
        # signed range stored with an offset so codes stay unsigned.
        half = 2 ** (bits - 1) - 1
        return (-half, half)
    return (0.0, 2.0**bits - 1.0)


def _reduce(fn, x: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    """``fn`` (amin / amax) over ``axes`` keeping dims; ``x`` itself over no
    axis (``torch.amax`` reduces every axis when given an empty tuple,
    ``jnp.max`` none)."""
    return fn(x, dim=axes, keepdim=True) if axes else x


def quantize(
    x: torch.Tensor,
    scheme: str = "int4_asym",
    channel_axis: Optional[int] = -1,
    reduce_axes: Optional[Tuple[int, ...]] = None,
    pack: bool = False,
) -> QuantizedTensor:
    """Quantize ``x`` with affine parameters per position of
    ``channel_axis``, the statistics reduced over every other axis (per
    tensor when ``channel_axis`` is None), or over ``reduce_axes`` when
    given.  JAX's operation order, so the f32 scale and zero are equal to
    the bit."""
    bits, symmetric = _SCHEMES[scheme]
    x = x.to(torch.float32)
    if reduce_axes is not None:
        reduce_axes = tuple(a % x.ndim for a in reduce_axes)
    elif channel_axis is None:
        reduce_axes = tuple(range(x.ndim))
    else:
        channel_axis = channel_axis % x.ndim
        reduce_axes = tuple(i for i in range(x.ndim) if i != channel_axis)

    qlo, qhi = _qrange(bits, symmetric)
    if symmetric:
        amax = _reduce(torch.amax, x.abs(), reduce_axes)
        scale = torch.clamp_min(amax / qhi, 1e-8)
        zero = torch.zeros_like(scale)
        q = torch.clamp(torch.round(x / scale), qlo, qhi)
        # store unsigned: code = q + qhi (int4_sym codes in [0, 14])
        codes = (q + qhi).to(torch.uint8)
    else:
        xmin = _reduce(torch.amin, x, reduce_axes)
        xmax = _reduce(torch.amax, x, reduce_axes)
        scale = torch.clamp_min((xmax - xmin) / qhi, 1e-8)
        zero = xmin
        codes = torch.clamp(torch.round((x - xmin) / scale), 0, qhi).to(torch.uint8)
    qt = QuantizedTensor(codes, scale, zero, bits, False, symmetric,
                         tuple(x.shape))
    return pack_codes(qt) if pack else qt


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    codes = unpack_codes(qt).codes.to(torch.float32)
    if qt.symmetric:
        half = 2.0 ** (qt.bits - 1) - 1.0
        return (codes - half) * qt.scale + qt.zero
    return codes * qt.scale + qt.zero


def pack_codes(qt: QuantizedTensor) -> QuantizedTensor:
    """Pack consecutive codes along the last axis, low bits first (INT4: two
    a byte, INT2: four); INT8 and packed tensors are returned as they are.
    JAX shifts in uint32; int32 gives the same bytes."""
    if qt.packed or qt.bits == 8:
        return qt
    codes = qt.codes
    per_byte = 8 // qt.bits
    if codes.shape[-1] % per_byte:
        raise ValueError(f"last axis {codes.shape[-1]} not a multiple of {per_byte}")
    grouped = codes.reshape(*codes.shape[:-1], codes.shape[-1] // per_byte,
                            per_byte).to(torch.int32)
    shifts = torch.arange(per_byte, dtype=torch.int32, device=codes.device) * qt.bits
    packed = (grouped << shifts).sum(dim=-1).to(torch.uint8)
    return QuantizedTensor(packed, qt.scale, qt.zero, qt.bits, True,
                           qt.symmetric, qt.logical_shape)


def unpack_codes(qt: QuantizedTensor) -> QuantizedTensor:
    if not qt.packed:
        return qt
    per_byte = 8 // qt.bits
    shifts = torch.arange(per_byte, dtype=torch.int32,
                          device=qt.codes.device) * qt.bits
    unpacked = (qt.codes.to(torch.int32)[..., None] >> shifts) & (2**qt.bits - 1)
    codes = unpacked.reshape(qt.logical_shape).to(torch.uint8)
    return QuantizedTensor(codes, qt.scale, qt.zero, qt.bits, False,
                           qt.symmetric, qt.logical_shape)


def fake_quantize(
    x: torch.Tensor, scheme: Optional[str], channel_axis: Optional[int] = -1
) -> torch.Tensor:
    """quantize -> dequantize round trip (the reference path of the tests
    and of the estimation oracle); f32 ``x`` for ``None`` / ``"none"``."""
    if scheme in (None, "none"):
        return x.to(torch.float32)
    qt = quantize(x, scheme, channel_axis)
    codes = qt.codes.to(torch.float32)
    if _SCHEMES[scheme][1]:
        half = 2.0 ** (qt.bits - 1) - 1.0
        return (codes - half) * qt.scale
    return codes * qt.scale + qt.zero


def quantization_error_bound(qt: QuantizedTensor) -> torch.Tensor:
    """Largest absolute reconstruction error: scale / 2 per channel."""
    return qt.scale * 0.5
