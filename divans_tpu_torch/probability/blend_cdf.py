"""BlendCDF16 — the geometric-blend CDF family (reference: feature `blend`,
src/probability/blend_cdf.rs:15-226).

An alternative to the counting Frequentist CDF: adaptation geometrically
blends the current CDF toward a one-hot-ish step distribution
(`to_blend`, :76-86), with a decaying mix rate and a uniform bias term
folded into `cdf()` reads (:159-173).  Not part of the wire format (the
reference feature-gates it off by default); provided for model research
and parity of the probability layer.

All state is int: (cdf int32[...,16] with max CDF_MAX-16, mix_rate, count).
Vectorized over leading batch dims; numpy/jnp interchangeable via `xp`.

A copy of divans_tpu/probability/blend_cdf.py
(the port imports nothing of that package).
"""
from __future__ import annotations

import numpy as np

from ..constants import BLEND_FIXED_POINT_PRECISION

CDF_MAX = 32767
DEL = CDF_MAX - 16
_SCALE = 1 << BLEND_FIXED_POINT_PRECISION
MIX_RATE_INIT = (1 << 10) + (1 << 9)


def fresh(batch_shape=(), xp=np):
    """(cdf, mix_rate, count) for a batch of blend CDFs."""
    cdf = xp.zeros(tuple(batch_shape) + (16,), xp.int32)
    mix_rate = xp.full(tuple(batch_shape), MIX_RATE_INIT, xp.int32)
    count = xp.zeros(tuple(batch_shape), xp.int32)
    return cdf, mix_rate, count


def to_blend(symbol, xp=np):
    """Step distribution: DEL where index >= symbol (blend_cdf.rs:76-86)."""
    symbol = xp.asarray(symbol, xp.int32)
    idx = xp.arange(16, dtype=xp.int32)
    return xp.where(idx >= symbol[..., None], DEL, 0).astype(xp.int32)


def mul_blend(baseline, blend_target, blend, bias, xp=np):
    """(baseline*(S-blend) + target*blend + bias) >> P (blend_cdf.rs:15-55)."""
    blend = xp.asarray(blend, xp.int32)[..., None]
    bias = xp.asarray(bias, xp.int32)[..., None]
    v = (blend_target * blend + baseline * (_SCALE - blend) + bias)
    return (v >> BLEND_FIXED_POINT_PRECISION).astype(xp.int32)


def _blend_internal(cdf, blend_target, mix_rate, count, xp=np):
    bias = (count & 0xF) << (BLEND_FIXED_POINT_PRECISION - 4)
    cdf = mul_blend(cdf, blend_target, mix_rate, bias, xp)
    # renormalize up while cdf[15] decays low (blend_cdf.rs:118-124)
    low = cdf[..., 15:16] < (CDF_MAX - 16) - (cdf[..., 15:16] >> 1)
    return xp.where(low, cdf + (cdf >> 1), cdf)


def blend(cdf, mix_rate, count, symbol, xp=np):
    """One adaptation step; returns (cdf', mix_rate', count')."""
    count = count + 1
    cdf = _blend_internal(cdf, to_blend(symbol, xp), mix_rate, count, xp)
    mix_rate = mix_rate - (mix_rate >> 7)   # geometric decay (:219-221)
    return cdf, mix_rate, count


def average(cdf_a, mix_a, cnt_a, cdf_b, mix_rate, xp=np):
    """CDF16::average for the blend family (blend_cdf.rs:177-182)."""
    return _blend_internal(cdf_a, cdf_b, xp.asarray(mix_rate, xp.int32),
                           cnt_a, xp)


def cdf_lookup(cdf, symbol, xp=np):
    """BaseCDF::cdf with the uniform latent-bias term (blend_cdf.rs:159-173)."""
    symbol = xp.asarray(symbol, xp.int32)
    c_sym = xp.take_along_axis(cdf, symbol[..., None], axis=-1)[..., 0]
    bias = CDF_MAX - cdf[..., 15]
    biased = c_sym + ((bias * (symbol + 1)) >> 4)
    return xp.where(symbol == 15, CDF_MAX, biased).astype(xp.int32)


def pdf(cdf, symbol, xp=np):
    prev = xp.where(symbol > 0,
                    cdf_lookup(cdf, xp.maximum(symbol - 1, 0), xp), 0)
    return cdf_lookup(cdf, symbol, xp) - prev
