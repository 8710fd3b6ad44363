"""CDF adaptation-rate pairs ("speeds") and their wire encoding (a copy of
divans_tpu/probability/speed.py).

Semantics match the reference (src/probability/interface.rs:298-375,
speed_to_u8/u8_to_speed at :566-585): a Speed is an (inc, lim) pair —
`inc` is added to cdf[sym..] on every observation; when cdf[15] reaches
`lim` the CDF is renormalized.  The f8 wire encoding is a 5.3 minifloat.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Speed:
    inc: int
    lim: int

    def __post_init__(self):
        assert 0 <= self.inc <= 0x4000
        assert 0 <= self.lim <= 0x4000

    def to_f8_tuple(self) -> tuple[int, int]:
        return (speed_to_u8(self.inc), speed_to_u8(self.lim))

    @staticmethod
    def from_f8_tuple(t: tuple[int, int]) -> "Speed":
        return Speed(u8_to_speed(t[0]), u8_to_speed(t[1]))


GEOLOGIC = Speed(0x0001, 0x4000)
GLACIAL = Speed(0x0004, 0x0A00)
MUD = Speed(0x0010, 0x2000)
SLOW = Speed(0x0020, 0x1000)
MED = Speed(0x0030, 0x4000)
FAST = Speed(0x0060, 0x4000)
PLANE = Speed(0x0080, 0x4000)
ROCKET = Speed(0x0180, 0x4000)

NAMED_SPEEDS = {
    "GEOLOGIC": GEOLOGIC, "GLACIAL": GLACIAL, "MUD": MUD, "SLOW": SLOW,
    "MED": MED, "FAST": FAST, "PLANE": PLANE, "ROCKET": ROCKET,
}

# 15-entry palette used when serializing adaptation speeds in the
# PredictionMode header (reference interface.rs:303-320).
ENCODER_DEFAULT_PALETTE = (
    Speed(0, 1024), Speed(2, 1024), Speed(1, 128), Speed(1, 16384),
    Speed(2, 2048), Speed(4, 1024), Speed(8, 8192), Speed(16, 48),
    Speed(16, 8192), Speed(32, 4096), Speed(64, 16384), Speed(128, 256),
    Speed(128, 16384), Speed(512, 16384), Speed(1664, 16384),
)

SPEED_PALETTE_SIZE = len(ENCODER_DEFAULT_PALETTE)

# default adaptation speed for literal CDFs (reference codec/interface.rs:188-190)
DEFAULT_LITERAL_SPEED = MUD


def speed_to_u8(v: int) -> int:
    """5.3 minifloat encode: (bit_length << 3) | top-3 mantissa bits."""
    assert 0 <= v < (1 << 15)
    length = v.bit_length()
    if v == 0:
        return 0
    rem = v - (1 << (length - 1))
    mantissa = (rem << 3) >> (length - 1)
    return ((length << 3) | mantissa) & 0xFF


def u8_to_speed(b: int) -> int:
    if b < 8:
        return 0
    log_val = (b >> 3) - 1
    rem = (b & 0x7) << log_val
    return (1 << log_val) | (rem >> 3)
