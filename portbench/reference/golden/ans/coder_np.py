"""The serial rANS coder (rans32) and the lane parser: a copy of
divans_tpu/ans/coder_np.py, the normative spec of the coder, plus the
lane parser of divans_tpu/ans/kernels.py.

State x is a u32 in [2^15, 2^31) while streaming (L = M = 2^15, b =
2^16).  Encode walks the symbols backward from ENC_START_STATE: if x >=
freq << 16 it emits x & 0xFFFF and shifts x right by 16, then x = (x //
freq) << 15 + x % freq + start.  Decode pulls one u16 renorm word when x
< 2^15, then slot = x & 0x7FFF and x = freq * (x >> 15) + slot - start.
A stream is its u32 final state (little-endian) ++ the u16 renorm words
in decode order.  The serial coder serves the golden engine
(codec/engine_np); the card's kernels compute the same function.
"""
from __future__ import annotations

import numpy as np

from ..constants import LOG2_SCALE

RENORM_BITS = 16
STATE_LOW = 1 << LOG2_SCALE           # 2^15: lower bound of the state interval
ENC_START_STATE = STATE_LOW
SCALE_MASK = (1 << LOG2_SCALE) - 1


class ANSEncoder:
    """Buffers (start, freq) pairs; reverse-encodes at flush."""

    def __init__(self):
        self._pairs: list[tuple[int, int]] = []  # chronological order

    def put(self, start: int, freq: int) -> None:
        assert 0 <= start < (1 << LOG2_SCALE), start
        assert 0 < freq <= (1 << LOG2_SCALE), freq
        assert start + freq <= (1 << LOG2_SCALE), (start, freq)
        self._pairs.append((start, freq))

    def flush(self) -> bytes:
        return self.flush_with_marks()[0]

    def flush_with_marks(self) -> tuple[bytes, list[int]]:
        """(wire bytes, cumulative pull counts): marks[S] = number of
        renorm-word pulls a decoder makes while decoding the first S
        symbols, so the stream PREFIX needed to decode them is
        4 + 2*marks[S] bytes (0 when S == 0 and the stream is empty).
        The streamed container's sub-frame chunk table is built from
        these (bounded-latency streaming; the wire bytes are identical
        to flush())."""
        if not self._pairs:
            return b"", [0]
        state = ENC_START_STATE
        n = len(self._pairs)
        pulled = [0] * n
        words: list[int] = []  # u16 renorm words, reverse-chronological emit order
        for j in range(n - 1, -1, -1):
            start, freq = self._pairs[j]
            if state >= (freq << RENORM_BITS):
                words.append(state & 0xFFFF)
                state >>= RENORM_BITS
                # by rANS symmetry this word is the one the decoder
                # pulls immediately before decoding symbol j
                pulled[j] = 1
            state = ((state // freq) << LOG2_SCALE) + (state % freq) + start
        out = bytearray(state.to_bytes(4, "little"))
        for w in reversed(words):  # wire order = forward-symbol (decode) order
            out += w.to_bytes(2, "little")
        marks = [0] * (n + 1)
        for j in range(n):
            marks[j + 1] = marks[j] + pulled[j]
        self._pairs.clear()
        return bytes(out), marks


class ANSDecoder:
    """Streaming decoder over a byte string; extend() appends more wire
    bytes mid-decode (the streamed container feeds prefixes chunk by
    chunk — prefix sufficiency is guaranteed by the encoder's chunk
    table, flush_with_marks)."""

    def __init__(self, data: bytes):
        self.data = data
        if len(data) >= 4:
            self.state = int.from_bytes(data[:4], "little")
            self.pos = 4
        else:
            self.state = 0
            self.pos = 0

    def extend(self, more: bytes) -> None:
        # amortized append: a bytes + bytes rebuild here is quadratic
        # over a streamed metablock's ~1000 chunk feeds
        if not isinstance(self.data, bytearray):
            self.data = bytearray(self.data)
        self.data += more
        if self.pos == 0 and len(self.data) >= 4:
            self.state = int.from_bytes(self.data[:4], "little")
            self.pos = 4

    def peek_offset(self) -> int:
        """15-bit cdf offset of the next symbol (pulls renorm word if due)."""
        if self.state < STATE_LOW:
            word = int.from_bytes(self.data[self.pos:self.pos + 2], "little")
            self.state = (self.state << RENORM_BITS) | word
            self.pos += 2
        return self.state & SCALE_MASK

    def advance(self, start: int, freq: int) -> None:
        self.state = freq * (self.state >> LOG2_SCALE) \
            + (self.state & SCALE_MASK) - start

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
