"""Format constants and RFC 7932 (brotli) literal-context lookup tables.

The port's own copy of divans_tpu/constants.py (the format is shared, the
code is not: this package imports nothing of divans_tpu).

The context tables are interoperability constants defined by RFC 7932 §7.1
(the brotli format); the reference codec uses the identical tables
(reference: src/constants.rs, consumed by src/codec/interface.rs:199-238).
We generate them from the spec's classification rules rather than embedding
the raw tables.
"""
import numpy as np

# ---------------------------------------------------------------- container
MAGIC = bytes([0xFF, 0x44, 0x56, 0x54])  # '\xffDVT'
FORMAT_VERSION = 1
FRAME_METABLOCK = 0x01
FRAME_METABLOCK_STREAMED = 0x02   # sub-frame chunk table + interleaved
                                  # cmd/lit payload (bounded-latency
                                  # streaming; reference mux.rs:23,445-478)
FRAME_EOF = 0xFE
TRAILER_SUFFIX = b"ans~"  # reference: src/codec/mod.rs:536-543 trailer magic

# fixed-point probability scale (reference: src/probability/interface.rs:426-430)
CDF_BITS = 15
LOG2_SCALE = 15
CDF_MAX = 32767
BLEND_FIXED_POINT_PRECISION = 15

# literal prediction modes (nibble values, reference interface.rs LiteralPredictionModeNibble)
LITERAL_PREDICTION_MODE_UTF8 = 3
LITERAL_PREDICTION_MODE_SIGN = 2
LITERAL_PREDICTION_MODE_MSB6 = 1
LITERAL_PREDICTION_MODE_LSB6 = 0


def _utf8_lut0() -> np.ndarray:
    """RFC 7932 UTF8-mode context contribution of the previous byte.

    ASCII bytes contribute 4×class (class 0..15) so the value ORs cleanly
    with the 2-bit p2 contribution (reference codec/literal.rs:106-107);
    non-ASCII bytes contribute the shared low contexts 0..3 directly."""
    ids = np.zeros(256, dtype=np.uint8)
    for b in (9, 10, 13):            # \t \n \r
        ids[b] = 1
    ids[32] = 2                      # space
    punct = {33: 3, 34: 4, 35: 3, 36: 3, 37: 5, 38: 3, 39: 4, 40: 6, 41: 7,
             42: 3, 43: 3, 44: 8, 45: 3, 46: 9, 47: 3,
             58: 8, 59: 8, 60: 6, 61: 10, 62: 7, 63: 3, 64: 3,
             91: 6, 92: 3, 93: 7, 94: 3, 95: 3, 96: 3,
             123: 6, 124: 3, 125: 7, 126: 3}
    for b, v in punct.items():
        ids[b] = v
    for b in range(48, 58):          # digits
        ids[b] = 11
    for b in range(65, 91):          # uppercase: vowels 12, consonants 13
        ids[b] = 12 if chr(b) in "AEIOU" else 13
    for b in range(97, 123):         # lowercase: vowels 14, consonants 15
        ids[b] = 14 if chr(b) in "aeiou" else 15
    lut = (ids << 2).astype(np.uint8)
    for b in range(128, 192):        # UTF-8 continuation bytes
        lut[b] = b & 1
    for b in range(192, 256):        # UTF-8 lead bytes
        lut[b] = 2 + (b & 1)
    return lut


def _utf8_context_ids_p2() -> np.ndarray:
    """RFC 7932 UTF8-mode 2-bit context class of the byte before previous."""
    ids = np.zeros(256, dtype=np.uint8)
    for b in range(33, 48):
        ids[b] = 1
    for b in range(48, 58):
        ids[b] = 2
    for b in range(58, 65):
        ids[b] = 1
    for b in range(65, 91):
        ids[b] = 2
    for b in range(91, 97):
        ids[b] = 1
    for b in range(97, 123):
        ids[b] = 3
    for b in range(123, 127):
        ids[b] = 1
    for b in range(224, 256):
        ids[b] = 2
    return ids


def _signed_3bit_context() -> np.ndarray:
    """RFC 7932 signed-mode 3-bit magnitude class."""
    ids = np.zeros(256, dtype=np.uint8)
    bounds = [(1, 16, 1), (16, 64, 2), (64, 128, 3), (128, 192, 4),
              (192, 240, 5), (240, 255, 6), (255, 256, 7)]
    for lo, hi, v in bounds:
        ids[lo:hi] = v
    return ids


UTF8_CONTEXT_P1 = _utf8_lut0()                 # final lut0 values
UTF8_CONTEXT_P2 = _utf8_context_ids_p2()       # id 0..3
SIGNED_3BIT_CONTEXT = _signed_3bit_context()   # id 0..7

_IDX = np.arange(256, dtype=np.uint8)


def literal_lut0(prediction_mode: int) -> np.ndarray:
    """Context contribution of the previous byte (reference codec/interface.rs:199-220)."""
    if prediction_mode == LITERAL_PREDICTION_MODE_SIGN:
        return (SIGNED_3BIT_CONTEXT << 3).astype(np.uint8)
    if prediction_mode == LITERAL_PREDICTION_MODE_UTF8:
        return UTF8_CONTEXT_P1.copy()
    if prediction_mode == LITERAL_PREDICTION_MODE_MSB6:
        return (_IDX >> 2).astype(np.uint8)
    if prediction_mode == LITERAL_PREDICTION_MODE_LSB6:
        return (_IDX & 0x3F).astype(np.uint8)
    raise ValueError(f"bad prediction mode {prediction_mode}")


def literal_lut1(prediction_mode: int) -> np.ndarray:
    """Context contribution of the byte before previous (codec/interface.rs:222-238)."""
    if prediction_mode == LITERAL_PREDICTION_MODE_SIGN:
        return SIGNED_3BIT_CONTEXT.copy()
    if prediction_mode == LITERAL_PREDICTION_MODE_UTF8:
        return UTF8_CONTEXT_P2.copy()
    if prediction_mode in (LITERAL_PREDICTION_MODE_MSB6, LITERAL_PREDICTION_MODE_LSB6):
        return np.zeros(256, dtype=np.uint8)
    raise ValueError(f"bad prediction mode {prediction_mode}")
