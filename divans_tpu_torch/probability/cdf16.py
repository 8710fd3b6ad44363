"""16-symbol adaptive CDF arithmetic on int32 tensors.

Torch twin of divans_tpu/probability/cdf16.py (the normative integer
semantics).  A CDF is the trailing axis of 16 cumulative counts; every
function keeps int32 end to end so the reference's i16 wraps happen.
"""
from __future__ import annotations

import functools

import torch

from ..constants import LOG2_SCALE
from .weights import bit_length_pos, floor_div, wrap_i16, xla_floor_div

CDF_INIT = tuple(range(4, 68, 4))  # [4, 8, ..., 64]


def cdf_init(batch_shape=(), device="cpu") -> torch.Tensor:
    """Fresh CDFs, int32[*batch_shape, 16]."""
    init = torch.tensor(CDF_INIT, dtype=torch.int32, device=device)
    return init.expand(*batch_shape, 16).contiguous()


@functools.lru_cache(maxsize=None)
def _consts(device):
    """(arange(16), the renorm's bias [1..16]) int32 on `device`."""
    idx = torch.arange(16, dtype=torch.int32, device=device)
    return idx, idx + 1


def blend(cdf: torch.Tensor, sym, inc, lim) -> torch.Tensor:
    """Adapt `cdf` toward `sym` with Speed(inc, lim)
    (FrequentistCDF16::blend): add inc to the entries at or above sym,
    then, when entry 15 >= lim, renormalize (c + bias) - ((c + bias) >>
    2), with the reference's i16 wraps.  sym, inc, lim: int32 scalars or
    tensors shaped like the CDFs' batch dims."""
    i32 = dict(dtype=torch.int32, device=cdf.device)
    sym, inc, lim = (torch.as_tensor(x, **i32)[..., None]
                     for x in (sym, inc, lim))
    idx, bias = _consts(cdf.device)
    c = wrap_i16(cdf + (idx >= sym) * inc)
    cb = wrap_i16(c + bias)
    renormed = wrap_i16(cb - (cb >> 2))
    return torch.where(c[..., 15:16] >= lim, renormed, c)


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


def sym_to_start_freq_xla(cdf: torch.Tensor, sym: torch.Tensor):
    """sym_to_start_freq as the reference's XLA programs compute it on
    any row, a wrapped one included: the quotients floor(c << 15 / max)
    with XLA's integer division (a max of 0 or below divides as
    weights.xla_floor_div says), and the sym == 0 term 0 whatever the
    max.  Equal to sym_to_start_freq on every row whose max is >= 1."""
    c = torch.gather(cdf, -1, torch.stack(
        [torch.clamp(sym - 1, min=0), sym], -1).long())
    r = xla_floor_div(c << LOG2_SCALE, cdf[..., 15:16])
    r_prev = torch.where(sym > 0, r[..., 0], 0)
    return r_prev + 1, r[..., 1] - r_prev - 1


def offset_to_sym(cdf: torch.Tensor, cdf_offset: torch.Tensor) -> torch.Tensor:
    """sym = #{i in 0..14 : cdf[i] <= (offset * max) >> 15}."""
    resc = (cdf_offset[..., None] * cdf[..., 15:16]) >> LOG2_SCALE
    return torch.sum(cdf[..., :15] <= resc, dim=-1, dtype=torch.int32)
