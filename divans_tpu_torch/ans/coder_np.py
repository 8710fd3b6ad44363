"""rans32 constants (the subset of divans_tpu/ans/coder_np.py the port
needs; that module is the normative spec of the coder).

State x is a u32 in [2^15, 2^31) while streaming; decode pulls one u16
renorm word when x < 2^15, then slot = x & 0x7FFF and
x = freq * (x >> 15) + slot - start.  Encode walks the symbols
backward from ENC_START_STATE: if x >= freq << 16 it emits x & 0xFFFF
and shifts x right by 16, then x = (x // freq) << 15 + x % freq + start.
"""
from __future__ import annotations

from ..constants import LOG2_SCALE

RENORM_BITS = 16
STATE_LOW = 1 << LOG2_SCALE
ENC_START_STATE = STATE_LOW
SCALE_MASK = (1 << LOG2_SCALE) - 1
