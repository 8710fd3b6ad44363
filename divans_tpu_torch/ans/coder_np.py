"""rans32 constants (the subset of divans_tpu/ans/coder_np.py the decode
needs; that module is the normative spec of the coder).

State x is a u32 in [2^15, 2^31) while streaming; decode pulls one u16
renorm word when x < 2^15, then slot = x & 0x7FFF and
x = freq * (x >> 15) + slot - start.
"""
from __future__ import annotations

from ..constants import LOG2_SCALE

RENORM_BITS = 16
STATE_LOW = 1 << LOG2_SCALE
SCALE_MASK = (1 << LOG2_SCALE) - 1
