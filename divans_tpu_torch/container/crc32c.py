"""CRC32c (Castagnoli): the container's integrity checksum.

`crc32c` calls the native library's SSE4.2 path through the port's own
binding (native.py); `crc32c_py` is the pure numpy slicing-by-8 table,
kept as the readable definition the tests hold the native path to.
"""
from __future__ import annotations

import numpy as np

_POLY = 0x82F63B78  # reversed Castagnoli


def _make_tables() -> np.ndarray:
    t = np.zeros((8, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if (c & 1) else 0)
        t[0, i] = c
    for k in range(1, 8):
        for i in range(256):
            c = t[k - 1, i]
            t[k, i] = (c >> 8) ^ t[0, c & 0xFF]
    return t


_TABLES = _make_tables()
_T = [_TABLES[k] for k in range(8)]


def crc32c(data: bytes, crc: int = 0) -> int:
    from .. import native
    return native.crc32c(data, crc)


def crc32c_py(data: bytes, crc: int = 0) -> int:
    crc = (~crc) & 0xFFFFFFFF
    buf = np.frombuffer(data, dtype=np.uint8)
    n8 = len(buf) // 8 * 8
    for row in buf[:n8].reshape(-1, 8):
        b = row.tolist()
        lo = crc
        crc = int(_T[7][(lo ^ b[0]) & 0xFF] ^ _T[6][((lo >> 8) ^ b[1]) & 0xFF]
                  ^ _T[5][((lo >> 16) ^ b[2]) & 0xFF]
                  ^ _T[4][((lo >> 24) ^ b[3]) & 0xFF]
                  ^ _T[3][b[4]] ^ _T[2][b[5]] ^ _T[1][b[6]] ^ _T[0][b[7]])
    for b in buf[n8:].tolist():
        crc = (crc >> 8) ^ int(_T[0][(crc ^ b) & 0xFF])
    return (~crc) & 0xFFFFFFFF
