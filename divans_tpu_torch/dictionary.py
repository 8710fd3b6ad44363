"""RFC 7932 static dictionary loader.

Reads the vendored dictionary data file that divans_tpu ships
(divans_tpu/data/rfc7932_dict.bin): format data defined by the RFC, read
by path, not code imported from that package.  The native decoder needs
it for Dict commands (quality 11 streams).  Without the file the
dictionary is empty: Dict commands then fail to decode, as in the
reference.
"""
from __future__ import annotations

import functools
import os
import struct

NUM_TRANSFORMS = 121

VENDORED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "divans_tpu", "data", "rfc7932_dict.bin")


class StaticDictionary:
    def __init__(self, data: bytes, offsets_by_length: list[int],
                 transforms: list[tuple[bytes, int, bytes]]):
        self.data = data
        self.offsets_by_length = offsets_by_length
        self.transforms = transforms

    @property
    def available(self) -> bool:
        return bool(self.data)


def _load_vendored(path: str) -> StaticDictionary | None:
    """Parse the DVTD0001 file: magic, u32 data size, dictionary bytes,
    32 u32 offsets, u16 count, then per transform u8-len prefix, u8 type,
    u8-len suffix."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    if blob[:8] != b"DVTD0001":
        return None
    n = struct.unpack_from("<I", blob, 8)[0]
    pos = 12
    data = blob[pos:pos + n]
    pos += n
    offsets = list(struct.unpack_from("<32I", blob, pos))
    pos += 128
    ntr = struct.unpack_from("<H", blob, pos)[0]
    pos += 2
    transforms = []
    for _ in range(ntr):
        plen = blob[pos]
        prefix = blob[pos + 1:pos + 1 + plen]
        pos += 1 + plen
        ttype, slen = blob[pos], blob[pos + 1]
        suffix = blob[pos + 2:pos + 2 + slen]
        pos += 2 + slen
        transforms.append((prefix, ttype, suffix))
    if len(data) != n or ntr != NUM_TRANSFORMS:
        return None
    return StaticDictionary(data, offsets, transforms)


@functools.lru_cache(maxsize=1)
def load() -> StaticDictionary:
    return _load_vendored(VENDORED) or StaticDictionary(b"", [0] * 32, [])
