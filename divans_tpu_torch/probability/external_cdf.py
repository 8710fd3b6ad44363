"""ExternalProbCDF16 — caller-supplied per-bit literal probabilities
(reference: feature `external-literal-probability`,
src/probability/external_cdf.rs:19-70; coding path
src/codec/literal.rs:128-152, 662-698).

A literal command may carry 8 probability bytes per data byte (4 per
nibble: p(bit==1) in 0..255, MSB first).  When present, each content
nibble is coded against a one-shot CDF built by multiplying the bit
probabilities into a nibble distribution, averaging (f64, exactly as the
reference) with the *default* model CDF, and quantizing to a 15-bit
cumulative table.  The CDF never adapts and the adaptive literal model
is bypassed for those nibbles.

A copy of divans_tpu/probability/external_cdf.py
(the port imports nothing of that package).
"""
from __future__ import annotations

import numpy as np

from .scalar import CDF_INIT

PROB_BYTES_PER_BYTE = 8


def external_prob_cdf(probs4, mix_cdf=None) -> list[int]:
    """probs4: 4 ints 0..255 (bit 3..0 of the nibble, MSB first);
    mix_cdf: the 16-entry cumulative CDF to average with (default fresh).

    Returns the 16-entry cumulative CDF with max 32767
    (external_cdf.rs:20-70, bit-faithful f64 arithmetic)."""
    if mix_cdf is None:
        mix_cdf = CDF_INIT
    pcdf = np.ones(16, np.float64)
    for nibble in range(16):
        for bit in range(4):
            p1 = probs4[bit] / 255.0
            if nibble & (1 << (3 - bit)):
                pcdf[nibble] *= p1
            else:
                pcdf[nibble] *= 1.0 - p1
    mcdf = np.ones(16, np.float64)
    m = float(mix_cdf[15])
    for nibble in range(1, 16):
        mcdf[nibble] = (float(mix_cdf[nibble]) - float(mix_cdf[nibble - 1])) / m
    pcdf = (pcdf + mcdf) / 2.0
    cum = np.cumsum(pcdf)
    cum /= cum[-1]
    out = []
    for nibble in range(16):
        res = int(cum[nibble] * 32767.0)
        out.append(min(max(res, 1), 32767 - 1))
    return out


def probs_for_nibble(prob_slice: bytes, byte_index: int,
                     is_high: bool):
    """The 4 probability bytes for a nibble, or None if out of range.

    Matches literal.rs:137-146: the high nibble reads bytes
    [8i+4, 8i+8), the low nibble [8i, 8i+4)."""
    shift_offset = 4 if is_high else 0
    en = byte_index * 8 + shift_offset + 4
    if en > len(prob_slice):
        return None
    return prob_slice[en - 4:en]
