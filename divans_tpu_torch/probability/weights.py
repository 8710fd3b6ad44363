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
NORM_WEIGHT_INIT = 1 << (BLEND_FIXED_POINT_PRECISION - 1)
_SHIFT_16_BY_8 = 24


def bit_length_pos(x: torch.Tensor) -> torch.Tensor:
    """bit_length of non-negative int32 values, exactly: the exponent of
    frexp on the value in float64, which holds every int32 (never a
    float log2, which rounds near powers of two).  Inputs of 0 or below
    give 0, as in the reference."""
    e = torch.frexp(x.to(torch.float64))[1].to(x.dtype)
    return torch.where(x > 0, e, torch.zeros_like(e))


def floor_div(a: torch.Tensor, b) -> torch.Tensor:
    """Exact floor(a / b) in the dtype of `a` (torch's `//` on integer
    tensors; the reference reached the same values through an f32
    reciprocal plus integer fix-ups, a Mosaic workaround)."""
    return torch.div(a, b, rounding_mode="floor")


def xla_floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """floor(a / b) for any int32 divisor, as the reference's jnp `//`
    gives it: a divisor of 0 gives -1 for a == 0 and -2 otherwise (XLA's
    quotient by zero, -1, then the floor's fix-up).  Only a corrupt or
    wrapped CDF has a max <= 0."""
    zero = b == 0
    if not bool(zero.any()):
        return floor_div(a, b)
    q = floor_div(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.where(a == 0, -1, -2).to(a.dtype), q)


def shift_right(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x >> s with the reference's rule for a shift outside [0, 31]: the
    sign fills the word (XLA's and numpy's arithmetic shift)."""
    return x >> torch.where((s < 0) | (s > 31), 31, s)


def wrap_i16(x: torch.Tensor) -> torch.Tensor:
    """Wrap int32 values to the int16 two's-complement range (the cast to
    int16 keeps the low 16 bits, as ((x + 0x8000) & 0xFFFF) - 0x8000
    does)."""
    return x.to(torch.int16).to(x.dtype)


def fix_weights(w0: torch.Tensor, w1: torch.Tensor):
    """Rescale both weights when either approaches 2^24 (weights.rs:64-80)."""
    over = ((w0 | w1) & 0x7F000000) != 0
    ilog = torch.maximum(bit_length_pos(w0), bit_length_pos(w1))
    sh = torch.clamp(ilog - 24, min=0)
    return torch.where(over, w0 >> sh, w0), torch.where(over, w1 >> sh, w1)


def compute_new_weight(prob_i: torch.Tensor, weighted_prob: torch.Tensor,
                       w_i: torch.Tensor) -> torch.Tensor:
    """One model's weight after a step (weights.rs:108-133), int32: the
    2^15 of the efficacy folded into the shift, the sum wrapped to int32,
    then clamped to [1, WEIGHT_MAX]."""
    p1 = weighted_prob
    error = (1 << 15) - p1                   # == p0
    log_geo = bit_length_pos(p1 * error)
    adj = shift_right(error * (prob_i - p1), log_geo - 15)
    return torch.clamp(w_i + adj, 1, WEIGHT_MAX)


def update(w0: torch.Tensor, w1: torch.Tensor, prob0: torch.Tensor,
           prob1: torch.Tensor, weighted_prob: torch.Tensor):
    """One mixer step: (w0', w1', norm_weight'), all int32.  prob0/prob1:
    the coded symbol's freq under each model's CDF; weighted_prob: its
    freq under the mixed CDF that coded it."""
    w0, w1 = fix_weights(w0, w1)
    w0n, w1n = compute_new_weight(torch.stack([prob0, prob1]), weighted_prob,
                                  torch.stack([w0, w1])).unbind(0)
    return w0n, w1n, norm_weight(w0n, w1n)


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
