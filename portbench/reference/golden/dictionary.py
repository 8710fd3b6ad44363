"""RFC 7932 static dictionary: frozen copy of
divans_tpu_torch/dictionary.py for the benchmark's write reference,
which codes quality 10 (no Dict command), so load() returns the empty
dictionary and no data file is read."""
from __future__ import annotations

import functools

NUM_TRANSFORMS = 121
# word length -> log2(number of words) (RFC 7932)
DICT_BITS = [0, 0, 0, 0, 10, 10, 11, 11, 10, 10,
             10, 10, 10, 9, 9, 8, 7, 7, 8, 7,
             7, 6, 6, 5, 5]
TRANSFORM_UPPERCASE_FIRST = 10
TRANSFORM_UPPERCASE_ALL = 11

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


@functools.lru_cache(maxsize=1)
def load() -> StaticDictionary:
    """The empty dictionary: the benchmark's reference codes quality 10,
    which emits no Dict command, and reads no data file."""
    return StaticDictionary(b"", [0] * 32, [])
