"""rans32 constants and the lane parser (the subset of
divans_tpu/ans/coder_np.py and ans/kernels.py the port
needs; that module is the normative spec of the coder).

State x is a u32 in [2^15, 2^31) while streaming; decode pulls one u16
renorm word when x < 2^15, then slot = x & 0x7FFF and
x = freq * (x >> 15) + slot - start.  Encode walks the symbols
backward from ENC_START_STATE: if x >= freq << 16 it emits x & 0xFFFF
and shifts x right by 16, then x = (x // freq) << 15 + x % freq + start.
"""
from __future__ import annotations

import numpy as np

from ..constants import LOG2_SCALE

RENORM_BITS = 16
STATE_LOW = 1 << LOG2_SCALE
ENC_START_STATE = STATE_LOW
SCALE_MASK = (1 << LOG2_SCALE) - 1


def bytes_to_lane(data: bytes, width: int):
    """One lane's wire bytes (u32 final state ++ u16 words, little-endian;
    b"" for a lane that coded nothing) as (state, words int32[width],
    nwords), the words zero-padded.  The state keeps its 32 bits as a
    Python int."""
    if not data:
        return ENC_START_STATE, np.zeros(width, np.int32), 0
    state = int.from_bytes(data[:4], "little")
    w = np.frombuffer(data[4:], dtype="<u2").astype(np.int32)
    if w.shape[0] > width:
        raise ValueError(f"lane of {w.shape[0]} words in a row of {width}")
    words = np.zeros(width, np.int32)
    words[:w.shape[0]] = w
    return state, words, w.shape[0]
