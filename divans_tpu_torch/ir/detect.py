"""Encoder-side model detection: stride and adaptation-speed search.

The reference forwards `stride_detection_quality`,
`speed_detection_quality`, `prior_bitmask_detection` and
`force_stride_value` into brotli's metablock encoder, which samples the
input and picks the literal model configuration
(the reference's src/brotli_ir_gen.rs:374-444, option surface
src/interface.rs:444-484).  Here detection is a cheap vectorized numpy
pass over the input run once per compress() call, and materializes
purely as the PredictionMode header command (mixing-mask value
4 + stride - 1, adaptation speeds) — the wire format doesn't change,
only which model the header selects, so every decoder path already
understands the result.

Strides > 1 pay off on structured binary data (fixed-width records,
samples) where byte i correlates with byte i - s rather than i - 1; the
sampled conditional-entropy score below measures exactly that.

A copy of divans_tpu/ir/detect.py
(the port imports nothing of that package).
"""
from __future__ import annotations

import numpy as np

from ..probability.speed import Speed, ENCODER_DEFAULT_PALETTE

MAX_STRIDE = 8
# a stride > 1 must beat the stride-1 model by this relative margin on
# sampled entropy before we give up the context-map profile for it
STRIDE_MARGIN = 0.05


def _cond_entropy_bits(ctx: np.ndarray, sym: np.ndarray, n_ctx: int,
                       n_sym: int) -> float:
    """Total bits of `sym` under an ideal per-`ctx` static model."""
    counts = np.zeros((n_ctx, n_sym), np.int64)
    np.add.at(counts, (ctx, sym), 1)
    row = counts.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = counts / np.maximum(row, 1)
        bits = -np.where(counts > 0, counts * np.log2(p, where=p > 0), 0)
    return float(bits.sum())


def detect_stride(data: bytes, quality: int) -> int:
    """Best literal-prior stride in [1, 8] (1 = keep the cm profile).

    Scores each stride s by the sampled conditional entropy of the next
    byte's nibbles given the byte s back (the prior actually used by the
    literal coder when the mixing mask selects stride s), vs the
    stride-1/context baseline."""
    n = len(data)
    if n < 4096 or quality <= 0:
        return 1
    step = max(1, n // (2048 << min(quality, 9)))
    a = np.frombuffer(data, np.uint8)
    idx = np.arange(MAX_STRIDE, n, step)
    cur = a[idx]
    costs = []
    for s in range(1, MAX_STRIDE + 1):
        prev = a[idx - s]
        hi_bits = _cond_entropy_bits(prev, cur >> 4, 256, 16)
        lo_bits = _cond_entropy_bits(
            (prev.astype(np.int32) << 4) | (cur >> 4), cur & 0xF, 4096, 16)
        costs.append(hi_bits + lo_bits)
    best = int(np.argmin(costs)) + 1
    if best > 1 and costs[best - 1] < costs[0] * (1.0 - STRIDE_MARGIN):
        return best
    return 1


def _speed_cost_bits(ctx: np.ndarray, sym: np.ndarray, n_ctx: int,
                     speeds: list[Speed]) -> np.ndarray:
    """Coded bits of `sym` under per-ctx adaptive CDF16s, one total per
    candidate speed (vectorized over candidates — the findspeed shadow-
    CDF trick).  Exact frequentist blend semantics (scalar.blend)."""
    k = len(speeds)
    cdfs = np.tile(np.arange(4, 68, 4, np.int64), (k, n_ctx, 1))
    incs = np.array([s.inc for s in speeds], np.int64)[:, None]
    lims = np.array([s.lim for s in speeds], np.int64)[:, None]
    ge = np.arange(16, dtype=np.int64)[None, :]
    bias = np.arange(1, 17, dtype=np.int64)[None, :]
    bits = np.zeros(k)
    for c, v in zip(ctx, sym):
        row = cdfs[:, c, :]                           # [k, 16]
        freq = row[:, v] - (row[:, v - 1] if v else 0)
        bits -= np.log2(freq / row[:, 15])
        row = row + incs * (ge >= v)
        cb = row + bias
        renorm = row[:, 15:16] >= lims
        cdfs[:, c, :] = np.where(renorm, cb - (cb >> 2), row)
    return bits


def detect_speeds(data: bytes, quality: int,
                  stride: int) -> tuple[Speed, Speed, Speed, Speed]:
    """Pick literal adaptation speeds from the encoder palette by
    replaying sampled nibbles through real adaptive CDFs per candidate
    (the findspeed method, src/probability/variant_speed_cdf.rs:5-106,
    applied at encode time as the reference's speed_detection does)."""
    n = len(data)
    a = np.frombuffer(data, np.uint8)
    n_samp = min(n - stride, 1024 << min(quality, 4))
    start = max(stride, (n - n_samp) // 2)
    idx = np.arange(start, min(n, start + n_samp))
    cur = a[idx]
    prev = a[idx - stride]
    hi_ctx = prev >> 2            # 64 contexts, cm-profile-like resolution
    lo_ctx = cur >> 4             # low nibble keyed by the high nibble
    candidates = list(dict.fromkeys(
        ENCODER_DEFAULT_PALETTE))  # dedupe, keep order
    best = []
    for ctx, sym, n_ctx in ((hi_ctx, cur >> 4, 64), (lo_ctx, cur & 0xF, 16)):
        costs = _speed_cost_bits(ctx, sym, n_ctx, candidates)
        best.append(candidates[int(np.argmin(costs))])
    hi_sp, lo_sp = best[0], best[1]
    # [stride-low, stride-high, cm-low, cm-high]
    return (lo_sp, hi_sp, lo_sp, hi_sp)


def detect_prior_bitmask(data: bytes, quality: int,
                         max_stride: int = MAX_STRIDE) -> bytes | None:
    """Per-context mixing mask: for each 6-bit literal context, pick the
    better hi-nibble prior — the context-keyed model (mask 0) or a
    stride-s previous-byte model (mask 4 + s - 1) — by sampled
    conditional entropy.  Returns the 8192-entry mask (mv_mode=2 wire
    shape) or None when no context prefers a stride prior.

    The reference's prior_bitmask_detection serves the same role: decide
    per-prior-bucket which prior family the literal coder consults
    (src/interface.rs:444-484 option surface).  Only makes sense with
    the context map on; streams carrying a non-trivial mask decode on
    the golden engine (ratio mode, like block_split)."""
    from .. import constants
    from ..ir import commands as cmds

    n = len(data)
    if n < 8192 or quality <= 0:
        return None
    lut0 = constants.literal_lut0(constants.LITERAL_PREDICTION_MODE_UTF8)
    lut1 = constants.literal_lut1(constants.LITERAL_PREDICTION_MODE_UTF8)
    a = np.frombuffer(data, np.uint8)
    step = max(1, n // (4096 << min(quality, 8)))
    idx = np.arange(max_stride, n, step)
    cur_hi = a[idx] >> 4
    ctx = (lut0[a[idx - 1]] | lut1[a[idx - 2]]).astype(np.int64)
    # baseline: H(hi | ctx); stride s: H(hi | ctx, byte at -s) — the
    # joint keeps the comparison honest (the stride rows are shared
    # across contexts, but per-ctx adaptation makes them near-joint)
    base_bits = np.zeros(64)
    counts = np.zeros(64, np.int64)
    for c in range(64):
        m = ctx == c
        counts[c] = int(m.sum())
        if counts[c]:
            base_bits[c] = _cond_entropy_bits(
                np.zeros(counts[c], np.int64), cur_hi[m], 1, 16)
    best = np.zeros(64, np.int64)  # mask value per ctx (0 = keep)
    gain = np.zeros(64)
    for s in range(1, max_stride + 1):
        prev_s = a[idx - s].astype(np.int64)
        for c in range(64):
            m = ctx == c
            if counts[c] < 256:
                continue
            bits = _cond_entropy_bits(prev_s[m], cur_hi[m], 256, 16)
            # the stride model pays ~one fresh CDF per visited row
            penalty = 4.0 * len(np.unique(prev_s[m]))
            g = base_bits[c] - bits - penalty
            if g > gain[c] and g > 0.05 * base_bits[c]:
                gain[c] = g
                best[c] = 4 + s - 1
    if not best.any():
        return None
    mv = np.zeros(cmds.NUM_MIXING_VALUES, np.uint8)
    i = np.arange(cmds.NUM_MIXING_VALUES)
    mv[:] = best[(i & 0xFF) % 64]
    return mv.tobytes()


def apply_detection(data: bytes, options):
    """Resolve detection options against the input: returns an effective
    options object (possibly unchanged) whose force_stride_value /
    use_context_map / literal_adaptation reflect the detected model."""
    import dataclasses
    stride = options.force_stride_value
    if stride == 0 and options.stride_detection_quality > 0 and data:
        stride = detect_stride(data, options.stride_detection_quality)
        if stride > 1:
            # keep the context map: the constant mask selects the stride
            # prior per literal and the mixer still blends the cm prior —
            # the reference's mixed model (src/codec/literal.rs:153-259),
            # measured -1.8% vs dropping the cmap on the wave fixture
            options = dataclasses.replace(options, force_stride_value=stride)
    if (options.speed_detection_quality > 0 and data
            and options.literal_adaptation is None):
        speeds = detect_speeds(data, options.speed_detection_quality,
                               max(1, stride))
        options = dataclasses.replace(options, literal_adaptation=speeds)
    return options
