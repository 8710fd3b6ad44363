"""16-symbol adaptive CDF arithmetic on int32 tensors.

Torch twin of divans_tpu/probability/cdf16.py (the normative integer
semantics).  A CDF is the trailing axis of 16 cumulative counts; every
function keeps int32 end to end so the reference's i16 wraps happen.
"""
from __future__ import annotations

import torch

from ..constants import LOG2_SCALE
from .weights import bit_length_pos, floor_div, wrap_i16

CDF_INIT = tuple(range(4, 68, 4))  # [4, 8, ..., 64]


def cdf_init(batch_shape=(), device="cpu") -> torch.Tensor:
    """Fresh CDFs, int32[*batch_shape, 16]."""
    init = torch.tensor(CDF_INIT, dtype=torch.int32, device=device)
    return init.expand(*batch_shape, 16).contiguous()


def average(cdf_a: torch.Tensor, cdf_b: torch.Tensor, mix_rate) -> torch.Tensor:
    """mix_rate*a + (1-mix_rate)*b in 15-bit fixed point
    (FrequentistCDF16::average).  mix_rate: int32 scalar, or a tensor
    shaped like the CDFs' batch dims (a trailing axis is added)."""
    amax = cdf_a[..., 15:16]
    bmax = cdf_b[..., 15:16]
    shift = torch.clamp(bit_length_pos(amax * bmax) - 15, min=0)
    mix_rate = torch.as_tensor(mix_rate, dtype=torch.int32,
                               device=cdf_a.device)
    if mix_rate.ndim:
        mix_rate = mix_rate[..., None]
    inv_mix = (1 << 15) - mix_rate
    ra = (cdf_a * bmax) >> shift
    rb = (cdf_b * amax) >> shift
    return wrap_i16((ra * mix_rate + rb * inv_mix + 1) >> 15)


def _safe_max(cdf: torch.Tensor) -> torch.Tensor:
    """cdf[..., 15:16] floored at 1: a valid CDF's max is >= 1, where this
    is the identity; a corrupt stream cannot divide by zero."""
    return torch.clamp(cdf[..., 15:16], min=1)


def rescaled(cdf: torch.Tensor) -> torch.Tensor:
    """floor(cdf << 15 / max) for all 16 entries (the start/freq grid)."""
    return floor_div(cdf << LOG2_SCALE, _safe_max(cdf))


def freqs_all(cdf: torch.Tensor) -> torch.Tensor:
    """sym_to_start_freq's freq for every symbol at once."""
    r = rescaled(cdf)
    r_prev = torch.cat([torch.zeros_like(r[..., :1]), r[..., :-1]], dim=-1)
    return r - r_prev - 1


def sym_to_start_freq(cdf: torch.Tensor, sym: torch.Tensor):
    """(start, freq) of `sym` under `cdf`, rescaled to the 15-bit domain:
    start = floor(cdf[sym-1] << 15 / max) + 1 (0 term for sym == 0),
    freq = floor(cdf[sym] << 15 / max) - (start - 1) - 1.  Read off the
    rescaled grid with a leading 0: start - 1 = grid[sym] and
    start + freq = grid[sym + 1]."""
    grid = torch.nn.functional.pad(rescaled(cdf), (1, 0))
    bounds = torch.gather(grid, -1, torch.stack([sym, sym + 1], -1).long())
    start = bounds[..., 0] + 1
    return start, bounds[..., 1] - start


def offset_to_sym(cdf: torch.Tensor, cdf_offset: torch.Tensor) -> torch.Tensor:
    """sym = #{i in 0..14 : cdf[i] <= (offset * max) >> 15}."""
    resc = (cdf_offset[..., None] * cdf[..., 15:16]) >> LOG2_SCALE
    return torch.sum(cdf[..., :15] <= resc, dim=-1, dtype=torch.int32)
