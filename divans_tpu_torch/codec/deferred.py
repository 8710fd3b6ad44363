"""Chunk-deferred adaptation: the constants and wire helpers of the
deferred profile that the port needs (a copy of the subset of
divans_tpu/codec/deferred.py, whose module notes are normative).

Within a chunk of S coded nibbles every model row and mixer weight is
frozen; chunk k's updates commit at the end of chunk k+1 (lag 1).  A
frame's literals are split into SUB_LIT-byte sub-streams, each with its
own rANS coder and a fresh literal model.
"""
from __future__ import annotations

from ..errors import ErrCode

MAX_RENORM_PASSES = 24
ADJ_CLAMP = 1 << 21
WEIGHT_MAX = (1 << 30) - 1
SUB_LIT = 1 << 15   # literal bytes per lit sub-stream (deferred-v3)


def cmd_chunk(chunk: int) -> int:
    """Per-stream ticking: the cmd stream's chunk (in steps) for a
    literal chunk of `chunk` nibbles."""
    return max(16, chunk >> 2)


# container flags byte: bits 0-1 profile, bits 2-4 chunk code
_CHUNK_SHIFT = 2
_CHUNK_BITS = 0b111


def lit_subs_join(subs: list[bytes]) -> bytes:
    """Assemble a frame's lit field from its sub-stream payloads."""
    from ..container.format import write_varint
    out = bytearray(write_varint(len(subs)))
    for s in subs[:-1]:
        out += write_varint(len(s))
    for s in subs:
        out += s
    return bytes(out)


def lit_subs_split(lit_field: bytes) -> list[bytes]:
    """Split a frame's lit field into its sub-stream payloads
    (varint(n_subs), varint(len(sub_i)) for i < n_subs-1, payloads)."""
    from ..container.format import read_varint, CorruptContainer
    if not lit_field:
        return [b""]
    n, pos = read_varint(lit_field, 0)
    if not 1 <= n <= 1 << 20:
        raise CorruptContainer(f"bad lit sub-stream count {n}",
                               ErrCode.BAD_LIT_SUBS)
    lens = []
    for _ in range(n - 1):
        ln, pos = read_varint(lit_field, pos)
        lens.append(ln)
    subs = []
    for ln in lens:
        if pos + ln > len(lit_field):
            raise CorruptContainer("lit sub-stream overruns the field",
                                   ErrCode.LIT_SUB_OVERRUN)
        subs.append(lit_field[pos:pos + ln])
        pos += ln
    subs.append(lit_field[pos:])
    return subs


def chunk_to_flags(chunk: int) -> int:
    """chunk (0 = adaptive, else power of two in [16, 1024]) -> flag bits."""
    if chunk == 0:
        return 0
    assert chunk & (chunk - 1) == 0 and 16 <= chunk <= 1024, chunk
    return (chunk.bit_length() - 4) << _CHUNK_SHIFT


def flags_to_chunk(flags: int) -> int:
    code = (flags >> _CHUNK_SHIFT) & _CHUNK_BITS
    return 0 if code == 0 else 1 << (code + 3)
