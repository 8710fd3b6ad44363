"""DTF container: header / metablock frames / crc trailer.

A copy of divans_tpu/container/format.py (DESIGN.md defines the format):

  header   : MAGIC[4] version[1] log2_window[1] flags[1] mb_log2[1] reserved[8]
  frame    : 0x01 varint(raw_len) varint(cmd_len) varint(lit_len)
             cmd_bytes lit_bytes
  eof      : 0xFE
  trailer  : crc32c(raw)[4] b"ans~"

  streamed : 0x02 varint(raw_len) varint(n_chunks)
             n_chunks x (varint(raw_delta) varint(cmd_len) varint(lit_len))
             the chunks' cmd and lit payloads, chunk by chunk

A streamed frame's chunk payloads are prefix slices of the two streams:
deserialize reassembles them into the plain frame, as the reference
does.  compress writes streamed frames for streaming_chunk_bytes > 0.
"""
from __future__ import annotations

import dataclasses

from .. import constants
from ..errors import CodedError, ErrCode
from .crc32c import crc32c


class CorruptContainer(CodedError):
    """Container-layer failure; `.code` names the failed check."""


@dataclasses.dataclass
class MetablockFrame:
    raw_len: int
    cmd: bytes
    lit: bytes


@dataclasses.dataclass
class StreamedMetablockFrame:
    """Bounded-latency frame: chunks = [(raw_delta, cmd_bytes,
    lit_bytes)], whose payloads concatenated are the plain frame's two
    streams (codec/engine_np.encode_metablock_streamed writes them)."""
    raw_len: int
    chunks: list


def write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_varint(data: bytes, pos: int) -> tuple[int, int]:
    n = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise CorruptContainer("truncated varint", ErrCode.TRUNCATED_VARINT)
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not (b & 0x80):
            return n, pos
        shift += 7
        if shift > 63:
            raise CorruptContainer("varint too long", ErrCode.VARINT_TOO_LONG)


def write_header(window_size: int, mb_log2: int, flags: int = 0) -> bytes:
    return (constants.MAGIC + bytes([constants.FORMAT_VERSION, window_size,
                                     flags, mb_log2]) + b"\x00" * 8)


def parse_header(data: bytes) -> tuple[int, int, int]:
    """returns (window_size, mb_log2, flags)"""
    if len(data) < 16 or data[:4] != constants.MAGIC:
        raise CorruptContainer("bad magic", ErrCode.BAD_MAGIC)
    if data[4] != constants.FORMAT_VERSION:
        raise CorruptContainer(f"unsupported version {data[4]}",
                               ErrCode.BAD_VERSION)
    window_size = data[5]
    if not 10 <= window_size <= 24:
        raise CorruptContainer(f"window size {window_size} out of range",
                               ErrCode.BAD_WINDOW)
    return window_size, data[7], data[6]


def write_frame(frame) -> bytes:
    if isinstance(frame, StreamedMetablockFrame):
        out = bytearray([constants.FRAME_METABLOCK_STREAMED])
        out += write_varint(frame.raw_len) + write_varint(len(frame.chunks))
        for rd, cb, lb in frame.chunks:
            out += write_varint(rd) + write_varint(len(cb)) \
                + write_varint(len(lb))
        for _rd, cb, lb in frame.chunks:
            out += cb + lb
        return bytes(out)
    return (bytes([constants.FRAME_METABLOCK])
            + write_varint(frame.raw_len) + write_varint(len(frame.cmd))
            + write_varint(len(frame.lit)) + frame.cmd + frame.lit)


def serialize(frames: list, window_size: int, mb_log2: int,
              crc: int, flags: int = 0) -> bytes:
    out = bytearray(write_header(window_size, mb_log2, flags))
    for f in frames:
        out += write_frame(f)
    out.append(constants.FRAME_EOF)
    out += crc.to_bytes(4, "little") + constants.TRAILER_SUFFIX
    return bytes(out)


def _read_streamed(data: bytes, pos: int) -> tuple[MetablockFrame, int]:
    """A streamed frame's chunk payloads are exact prefix slices of the
    two streams: concatenated they are the plain frame."""
    raw_len, pos = read_varint(data, pos)
    n_chunks, pos = read_varint(data, pos)
    if n_chunks > (raw_len + 1) * 2 + 16:
        raise CorruptContainer("implausible chunk count",
                               ErrCode.TRUNCATED_FRAME)
    table = []
    for _ in range(n_chunks):
        _rd, pos = read_varint(data, pos)
        cl, pos = read_varint(data, pos)
        ll, pos = read_varint(data, pos)
        table.append((cl, ll))
    cmd_parts, lit_parts = [], []
    for cl, ll in table:
        if pos + cl + ll > len(data):
            raise CorruptContainer("truncated frame payload",
                                   ErrCode.TRUNCATED_FRAME)
        cmd_parts.append(data[pos:pos + cl])
        pos += cl
        lit_parts.append(data[pos:pos + ll])
        pos += ll
    return MetablockFrame(raw_len, b"".join(cmd_parts),
                          b"".join(lit_parts)), pos


def deserialize(data: bytes) -> tuple[int, int, list[MetablockFrame], int, int]:
    """returns (window_size, mb_log2, frames, stored_crc, flags)."""
    window_size, mb_log2, flags = parse_header(data)
    pos = 16
    frames: list[MetablockFrame] = []
    while True:
        if pos >= len(data):
            raise CorruptContainer("missing EOF frame", ErrCode.MISSING_EOF)
        ftype = data[pos]
        pos += 1
        if ftype == constants.FRAME_EOF:
            break
        if ftype == constants.FRAME_METABLOCK_STREAMED:
            frame, pos = _read_streamed(data, pos)
            frames.append(frame)
            continue
        if ftype != constants.FRAME_METABLOCK:
            raise CorruptContainer(f"unknown frame type {ftype:#x}",
                                   ErrCode.TRUNCATED_FRAME)
        raw_len, pos = read_varint(data, pos)
        cmd_len, pos = read_varint(data, pos)
        lit_len, pos = read_varint(data, pos)
        if pos + cmd_len + lit_len > len(data):
            raise CorruptContainer("truncated frame payload",
                                   ErrCode.TRUNCATED_FRAME)
        cmd = data[pos:pos + cmd_len]
        pos += cmd_len
        lit = data[pos:pos + lit_len]
        pos += lit_len
        frames.append(MetablockFrame(raw_len, cmd, lit))
    if pos + 8 > len(data):
        raise CorruptContainer("truncated trailer", ErrCode.TRUNCATED_TRAILER)
    if data[pos + 4:pos + 8] != constants.TRAILER_SUFFIX:
        raise CorruptContainer("bad trailer magic", ErrCode.BAD_TRAILER_MAGIC)
    stored_crc = int.from_bytes(data[pos:pos + 4], "little")
    return window_size, mb_log2, frames, stored_crc, flags


def check_crc(raw: bytes, stored_crc: int) -> None:
    actual = crc32c(raw)
    if actual != stored_crc:
        raise CorruptContainer(
            f"crc mismatch: stored {stored_crc:#x} actual {actual:#x}",
            ErrCode.CRC_MISMATCH)
