"""Two-model mixer weights and the port's shared int32 helpers.

Torch twin of divans_tpu/probability/weights.py on int32 tensors.  Every
operation stays int32 so the wraps the format relies on happen exactly
as in the reference (norm_weight's i16 cast; see that module's notes on
the int32-exact rules).

`bit_length_pos` and `floor_div` are the port's ONE copy of the
shift-ladder bit length and exact integer division: cdf16.py and the
decode commit (codec/decode.py) import them from here.
"""
from __future__ import annotations

import torch

from ..constants import BLEND_FIXED_POINT_PRECISION

WEIGHT_MAX = (1 << 30) - 1
_SHIFT_16_BY_8 = 24


def bit_length_pos(x: torch.Tensor) -> torch.Tensor:
    """bit_length of non-negative int32 values: the exact shift ladder
    (never a float log2, which rounds near powers of two).  Negative
    inputs give 0, as in the reference."""
    r = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        has = (x >> (r + shift)) > 0
        r = torch.where(has, r + shift, r)
    return r + (x > 0).to(x.dtype)


def floor_div(a: torch.Tensor, b) -> torch.Tensor:
    """Exact floor(a / b) in the dtype of `a` (torch's `//` on integer
    tensors; the reference reached the same values through an f32
    reciprocal plus integer fix-ups, a Mosaic workaround)."""
    return torch.div(a, b, rounding_mode="floor")


def wrap_i16(x: torch.Tensor) -> torch.Tensor:
    """Wrap int32 values to the int16 two's-complement range."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def fix_weights(w0: torch.Tensor, w1: torch.Tensor):
    """Rescale both weights when either approaches 2^24 (weights.rs:64-80)."""
    over = ((w0 | w1) & 0x7F000000) != 0
    ilog = torch.maximum(bit_length_pos(w0), bit_length_pos(w1))
    sh = torch.clamp(ilog - 24, min=0)
    return torch.where(over, w0 >> sh, w0), torch.where(over, w1 >> sh, w1)


def _mul_shift24(inv: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    """Exact (inv * num) >> 24 for inv < 2^24, num < 2^16, in int32."""
    hi = (inv >> 12) * num
    lo = (inv & 0xFFF) * num
    return (hi + (lo >> 12)) >> 12


def norm_weight(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """15-bit fixed-point w0/(w0+w1) via the 8-bit reciprocal
    (weights.rs:53-62), including the reference's i16 wraps."""
    total = w0 + w1
    sh = torch.clamp(bit_length_pos(total) - 8, min=0)
    total8 = total >> sh
    inv = 1 + floor_div(torch.full_like(total8, 1 << _SHIFT_16_BY_8), total8)
    num = (w0 >> sh) << 8
    q16 = wrap_i16(_mul_shift24(inv, num))
    return wrap_i16(q16 << (BLEND_FIXED_POINT_PRECISION - 8))
