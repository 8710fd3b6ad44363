"""CRC32C (Castagnoli, reflected polynomial 0x82F63B78) in numpy.

The benchmark's own checksum, written for it and sharing no code with
the program: the data is cut into LANE-byte lanes whose registers run
side by side (one table lookup a byte, vectorised across lanes), then
the lanes are chained in order, each step shifting the running register
past LANE zero bytes (a linear map, applied through four byte tables).
The bytes left after the last whole lane run one at a time.
"""
from __future__ import annotations

import functools

import numpy as np

POLY = 0x82F63B78
LANE = 4096


def _table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(POLY), t >> 1)
    return t.astype(np.uint32)


_T = _table()


@functools.lru_cache(maxsize=4)
def _shift_tables(n: int) -> np.ndarray:
    """uint32[4, 256]: entry [k, b] is the register b << 8k after n zero
    bytes, so a register r becomes the XOR of [k, (r >> 8k) & 255]."""
    v = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(n):
        v = _T[v & 0xFF] ^ (v >> 8)
    bits = (np.arange(256, dtype=np.uint32)[:, None]
            >> np.arange(8, dtype=np.uint32)[None]) & 1
    out = np.zeros((4, 256), np.uint32)
    for k in range(4):
        img = v[8 * k:8 * k + 8]
        out[k] = np.bitwise_xor.reduce(np.where(bits == 1, img[None], 0),
                                       axis=1)
    return out


def _shift(tabs: np.ndarray, r: int) -> int:
    return int(tabs[0, r & 0xFF] ^ tabs[1, (r >> 8) & 0xFF]
               ^ tabs[2, (r >> 16) & 0xFF] ^ tabs[3, r >> 24])


def crc32c(data: bytes, crc: int = 0) -> int:
    """The CRC32C of data, continuing from crc."""
    buf = np.frombuffer(data, np.uint8)
    reg = (~crc) & 0xFFFFFFFF
    lanes = len(buf) // LANE
    if lanes:
        cols = buf[:lanes * LANE].reshape(lanes, LANE).T.copy()
        r = np.zeros(lanes, np.uint32)
        for j in range(LANE):
            r = _T[(r ^ cols[j]) & 0xFF] ^ (r >> 8)
        tabs = _shift_tables(LANE)
        for g in r.tolist():
            reg = _shift(tabs, reg) ^ g
    for b in buf[lanes * LANE:].tolist():
        reg = int(_T[(reg ^ b) & 0xFF]) ^ (reg >> 8)
    return (~reg) & 0xFFFFFFFF
