"""RFC 7932 static dictionary loader.

Reads the vendored dictionary data file that divans_tpu ships
(divans_tpu/data/rfc7932_dict.bin): format data defined by the RFC, read
by path, not code imported from that package.  The native decoder needs
it for Dict commands (quality 11 streams), and the quality-11 matcher
(ir/matcher) indexes its transformed words.  Without the file the
dictionary is empty: Dict commands then fail to decode, as in the
reference.
"""
from __future__ import annotations

import functools
import os
import struct

NUM_TRANSFORMS = 121
# word length -> log2(number of words) (RFC 7932)
DICT_BITS = [0, 0, 0, 0, 10, 10, 11, 11, 10, 10,
             10, 10, 10, 9, 9, 8, 7, 7, 8, 7,
             7, 6, 6, 5, 5]
TRANSFORM_UPPERCASE_FIRST = 10
TRANSFORM_UPPERCASE_ALL = 11

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

    def raw_word(self, word_size: int, word_id: int) -> bytes:
        assert 4 <= word_size <= 24
        assert word_id < (1 << DICT_BITS[word_size])
        off = self.offsets_by_length[word_size] + word_size * word_id
        return self.data[off:off + word_size]

    def transform_word(self, word_size: int, word_id: int,
                       transform_id: int) -> bytes:
        """TransformDictionaryWord semantics (RFC 7932 section 8)."""
        prefix, ttype, suffix = self.transforms[transform_id]
        word = bytearray(self.raw_word(word_size, word_id))
        if 1 <= ttype <= 9:          # OmitLast1..9
            word = word[:max(0, len(word) - ttype)]
        elif 12 <= ttype <= 20:      # OmitFirst1..9
            word = word[min(len(word), ttype - 11):]
        elif ttype == TRANSFORM_UPPERCASE_FIRST:
            if word:
                _ferment(word, 0)
        elif ttype == TRANSFORM_UPPERCASE_ALL:
            i = 0
            while i < len(word):
                i += _ferment(word, i)
        return bytes(prefix) + bytes(word) + bytes(suffix)


def _ferment(buf: bytearray, pos: int) -> int:
    """Uppercase one (possibly multi-byte) character at pos; returns its
    width in bytes."""
    c = buf[pos]
    if c < 192:
        if 97 <= c <= 122:
            buf[pos] = c ^ 32
        return 1
    if c < 224:
        if pos + 1 < len(buf):
            buf[pos + 1] ^= 32
        return 2
    if pos + 2 < len(buf):
        buf[pos + 2] ^= 5
    return 3


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
