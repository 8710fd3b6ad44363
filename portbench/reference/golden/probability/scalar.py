"""Scalar (pure-Python int) implementations of the probability ops.

These are the golden serial engine's hot path: operating on plain lists
of 16 ints is ~10x faster than per-call numpy for scalar work.  Test
suite asserts bit-identity with probability.cdf16 / probability.weights
(the analog of the reference's cross-implementation CDF equivalence
tests, src/probability/common_tests.rs:152-185).

A copy of divans_tpu/probability/scalar.py
(the port imports nothing of that package).
"""
from __future__ import annotations

CDF_INIT = [4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44, 48, 52, 56, 60, 64]


def _wrap_i16(x: int) -> int:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def blend(cdf: list[int], sym: int, inc: int, lim: int) -> None:
    """In-place FrequentistCDF16::blend (frequentist_cdf.rs:73-85)."""
    for i in range(sym, 16):
        cdf[i] = _wrap_i16(cdf[i] + inc)
    if cdf[15] >= lim:
        for i in range(16):
            cb = _wrap_i16(cdf[i] + i + 1)
            cdf[i] = _wrap_i16(cb - (cb >> 2))


def average(cdf_a: list[int], cdf_b: list[int], mix_rate: int) -> list[int]:
    """Mixed CDF (frequentist_cdf.rs:56-72); mix_rate in [0, 32768] weights a."""
    amax = cdf_a[15]
    bmax = cdf_b[15]
    shift = max((amax * bmax).bit_length() - 15, 0)
    inv = (1 << 15) - mix_rate
    return [_wrap_i16((((a * bmax) >> shift) * mix_rate
                       + ((b * amax) >> shift) * inv + 1) >> 15)
            for a, b in zip(cdf_a, cdf_b)]


def sym_to_start_freq(cdf: list[int], sym: int) -> tuple[int, int]:
    maxv = cdf[15]
    r_sym = (cdf[sym] << 15) // maxv
    r_prev = (cdf[sym - 1] << 15) // maxv if sym > 0 else 0
    return r_prev + 1, r_sym - r_prev - 1


def offset_to_sym(cdf: list[int], cdf_offset: int) -> int:
    rescaled = (cdf_offset * cdf[15]) >> 15
    sym = 0
    for i in range(15):
        if rescaled >= cdf[i]:
            sym = i + 1
        else:
            break
    return sym


# ----------------------------------------------------------------- weights

def weights_update(w: list[int], prob0: int, prob1: int, weighted_prob: int) -> None:
    """In-place mixer update; w = [w0, w1, norm_weight] (weights.rs:22-38).

    Departure from the reference: weights are clamped to [1, 2^30 - 1]
    (the reference only floors at 1), so every intermediate — including
    w0 + w1 in norm_weight — provably fits int32.  This makes the whole
    mixer int32-exact on TPU; encoder and decoder agree by construction.
    """
    w0, w1 = w[0], w[1]
    if (w0 | w1) & 0x7F000000:
        ilog = max(w0.bit_length(), w1.bit_length())
        if ilog >= 24:
            w0 >>= ilog - 24
            w1 >>= ilog - 24
    total = 1 << 15
    p1 = weighted_prob
    p0 = total - p1
    error = total - p1
    log_geo = (p1 * p0).bit_length()
    new = []
    for wi, n1i in ((w0, prob0), (w1, prob1)):
        # (error * (n1i - p1) * 2^15) >> log_geo, with the 2^15 folded into
        # the shift: log_geo >= 15 always since p1*p0 >= 2^15 - 1.
        adj = (error * (n1i - p1)) >> (log_geo - 15)
        s = wi + adj
        s = ((s + 0x80000000) & 0xFFFFFFFF) - 0x80000000
        new.append(min(max(1, s), (1 << 30) - 1))
    w[0], w[1] = new
    w[2] = norm_weight(w[0], w[1])


def norm_weight(w0: int, w1: int) -> int:
    """15-bit fixed-point w0/(w0+w1) via 8-bit reciprocal (weights.rs:53-62)."""
    total = w0 + w1
    sh = max(total.bit_length() - 8, 0)
    total8 = total >> sh
    inv = 1 + (1 << 24) // total8
    q = (inv * ((w0 >> sh) << 8)) >> 24
    q16 = _wrap_i16(q)
    return _wrap_i16(q16 << 7)


WEIGHT_INIT = [1, 1, 1 << 14]  # [w0, w1, norm_weight]
