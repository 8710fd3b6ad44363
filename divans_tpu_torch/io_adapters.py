"""Streaming I/O adapters: the port of divans_tpu/io_adapters.py (the
reference codec's writer and reader, std::io Write and Read wrappers).

The format is metablock-framed, so streaming falls out of buffering one
metablock at a time: the writer coalesces input until a metablock
boundary and emits complete frames; the reader consumes frames as they
complete (a streamed frame chunk by chunk).  Memory is bounded by one
metablock either way.  The container's crc32c trailer covers the whole
stream and is computed as it goes.

Both adapters run on the host, as the reference's do: each frame is
coded by the native library (native.build_trace and encode_streams;
native.decode_metablock), else (a frame it refuses, or every frame
without it) by the golden engine (codec/engine_np, codec/deferred).
They launch nothing on the card and take no device; a card launch a
metablock would be slower than the host (the adaptive decode scan
takes tens of ms on one frame).
"""
from __future__ import annotations

import io

from . import errors, native
from .codec import deferred, engine_np
from .codec.layout import (FLAG_PROFILES, PROFILE_FLAGS, PROFILES,
                           ModelLayout, profile_for_options)
from .container import format as fmt
from .container.crc32c import crc32c
from .ir.matcher import build_commands
from .options import DivansOptions


class CompressorWriter(io.RawIOBase):
    """Write raw bytes; compressed container bytes flow to `sink`.

    close() (or flush_final()) emits the trailing frame + checksum."""

    def __init__(self, sink, options: DivansOptions | None = None,
                 engine: str = "auto"):
        self.sink = sink
        self.options = options or DivansOptions()
        self.engine = engine
        self._buf = bytearray()
        self._crc = 0
        self._started = False
        self._finished = False

    def writable(self) -> bool:
        return True

    def _emit_header(self) -> None:
        if not self._started:
            self.sink.write(fmt.write_header(
                self.options.window_size, self.options.mb_log2,
                PROFILE_FLAGS[profile_for_options(self.options)]))
            self._started = True

    def _emit_block(self, raw: bytes) -> None:
        self._emit_header()
        if self.options.streaming_chunk_bytes:
            # bounded-latency frames: sub-frame chunk table so a reader
            # emits output per chunk, not per metablock
            chunks = engine_np.encode_metablock_streamed(
                raw, build_commands(raw, self.options), self.options,
                self.options.streaming_chunk_bytes)
            self.sink.write(fmt.write_frame(
                fmt.StreamedMetablockFrame(len(raw), chunks)))
            self._crc = crc32c(raw, self._crc)
            return
        cmd_b = lit_b = None
        if self.engine in ("auto", "native"):
            layout = ModelLayout(
                PROFILES[profile_for_options(self.options)])
            trace = native.build_trace(raw, self.options, layout)
            if trace is None and native.load() is not None:
                trace = native.build_trace_cmds(
                    raw, build_commands(raw, self.options), self.options,
                    layout)
            if trace is not None:
                cmd_b, lit_b = native.encode_streams(trace, layout.num_rows)
        if cmd_b is None:
            commands = build_commands(raw, self.options)
            cmd_b, lit_b = engine_np.encode_metablock(raw, commands,
                                                      self.options)
        self.sink.write(fmt.write_frame(fmt.MetablockFrame(len(raw), cmd_b,
                                                           lit_b)))
        self._crc = crc32c(raw, self._crc)

    def write(self, data) -> int:
        if self._finished:
            raise ValueError("write after close")
        self._buf += bytes(data)
        mb = self.options.metablock_size
        while len(self._buf) >= mb:
            self._emit_block(bytes(self._buf[:mb]))
            del self._buf[:mb]
        return len(data)

    def flush(self) -> None:
        """Mid-stream flush: everything written so far becomes decodable
        by a reader NOW — the buffered remainder is emitted as a (short)
        metablock frame.  The reference's analog is flush-at-any-byte
        (src/interface.rs:104-143); here the resume granularity is one
        frame, which a flush creates on demand.  Flushing early costs
        ratio (a fresh model per frame), exactly like the reference's
        flush costs a coder reset."""
        if self._finished:
            return  # no-op after flush_final (io.IOBase.close flushes)
        self._emit_header()
        if self._buf:
            self._emit_block(bytes(self._buf))
            self._buf.clear()

    def flush_final(self) -> None:
        if self._finished:
            return
        self._emit_header()
        if self._buf:
            self._emit_block(bytes(self._buf))
            self._buf.clear()
        self.sink.write(bytes([fmt.constants.FRAME_EOF]))
        self.sink.write(self._crc.to_bytes(4, "little")
                        + fmt.constants.TRAILER_SUFFIX)
        self._finished = True

    def close(self) -> None:
        if not self.closed:
            self.flush_final()
            super().close()


class DecompressorReader(io.RawIOBase):
    """Read decompressed bytes from a compressed-container `source`.

    With `partial=True`, running out of source bytes mid-frame is not an
    error: read() returns what is decodable now and `needs_input` turns
    True — push-style streaming (the C API's divans_decode loop)."""

    def __init__(self, source, options: DivansOptions | None = None,
                 partial: bool = False):
        self.source = source
        self.partial = partial
        self.needs_input = False
        self.options = options or DivansOptions()
        self._in = bytearray()
        self._out = bytearray()
        self._pos = 0          # parse position inside self._in
        self._header_done = False
        self._eof = False
        self._crc = 0
        self._stored_crc = None
        self._flags = 0
        # in-flight STREAMED frame (bounded-latency decode): the chunk
        # table + an incremental golden decoder; output flows per chunk
        self._sdec = None
        self._stable: list | None = None
        self._schunk = 0

    def readable(self) -> bool:
        return True

    def _fill(self, n: int = 1 << 16) -> bool:
        chunk = self.source.read(n)
        if chunk:
            self._in += chunk
            return True
        return False

    def _dry(self, msg: str) -> bool:
        """Source ran dry mid-structure: suspend (partial) or fail."""
        if self.partial:
            self.needs_input = True
            return False
        raise fmt.CorruptContainer(msg)

    def _step_streamed(self) -> bool:
        """Consume ready chunks of the in-flight streamed frame; True
        when any output was produced (decode latency = one chunk, not
        one metablock — the reference's bounded-latency interleave,
        mux.rs:23,445-478)."""
        produced = False
        data = self._in
        while self._schunk < len(self._stable):
            rd, cl, ll = self._stable[self._schunk]
            if cl + ll > len(data):
                if self._fill():
                    continue
                if produced:
                    return True
                return self._dry("truncated streamed chunk")
            raw = self._sdec.feed(rd, bytes(data[:cl]),
                                  bytes(data[cl:cl + ll]))
            del data[:cl + ll]
            self._schunk += 1
            if self._schunk == len(self._stable):
                raw += self._sdec.finish()
            if raw:
                self._crc = crc32c(raw, self._crc)
                self._out += raw
                produced = True
        self._sdec = None
        self._stable = None
        self._schunk = 0
        self._pos = 0
        return produced or True

    def _step(self) -> bool:
        """Try to decode one frame (or one streamed chunk) from the
        input buffer."""
        if self._sdec is not None:
            return self._step_streamed()
        data = self._in
        if not self._header_done:
            while len(data) < 16:
                if not self._fill():
                    return self._dry("truncated header")
            _w, _mb, self._flags = fmt.parse_header(bytes(data[:16]))
            self._pos = 16
            self._header_done = True
        while True:
            if self._pos >= len(data):
                if not self._fill():
                    return self._dry("truncated stream")
                continue
            ftype = data[self._pos]
            if ftype == fmt.constants.FRAME_EOF:
                while len(data) < self._pos + 9:
                    if not self._fill():
                        return self._dry("truncated trailer")
                if bytes(data[self._pos + 5:self._pos + 9]) != \
                        fmt.constants.TRAILER_SUFFIX:
                    raise fmt.CorruptContainer("bad trailer magic", errors.ErrCode.BAD_TRAILER_MAGIC)
                self._stored_crc = int.from_bytes(
                    data[self._pos + 1:self._pos + 5], "little")
                if self._stored_crc != self._crc:
                    raise fmt.CorruptContainer("crc mismatch", errors.ErrCode.CRC_MISMATCH)
                self._eof = True
                return False
            if ftype == fmt.constants.FRAME_METABLOCK_STREAMED:
                try:
                    raw_len, p = fmt.read_varint(data, self._pos + 1)
                    n_chunks, p = fmt.read_varint(data, p)
                    if n_chunks > (raw_len + 1) * 2 + 16:
                        raise fmt.CorruptContainer(
                            "implausible chunk count",
                            errors.ErrCode.TRUNCATED_FRAME)
                    table = []
                    for _ in range(n_chunks):
                        rd, p = fmt.read_varint(data, p)
                        cl, p = fmt.read_varint(data, p)
                        ll, p = fmt.read_varint(data, p)
                        table.append((rd, cl, ll))
                except fmt.CorruptContainer as e:
                    # only a short varint means "need more bytes"; a
                    # failed plausibility check is real corruption and
                    # must not be retried as truncation
                    if e.code != errors.ErrCode.TRUNCATED_VARINT:
                        raise
                    if not self._fill():
                        return self._dry("truncated streamed header")
                    continue
                del data[:p]
                self._pos = 0
                self._sdec = engine_np.StreamedMetablockDecoder(
                    raw_len, self.options)
                self._stable = table
                self._schunk = 0
                return self._step_streamed()
            try:
                raw_len, p = fmt.read_varint(data, self._pos + 1)
                cmd_len, p = fmt.read_varint(data, p)
                lit_len, p = fmt.read_varint(data, p)
                if p + cmd_len + lit_len > len(data):
                    raise fmt.CorruptContainer("partial frame", errors.ErrCode.PARTIAL_FRAME)
            except fmt.CorruptContainer:
                if not self._fill():
                    return self._dry("truncated frame")
                continue
            cmd = bytes(data[p:p + cmd_len])
            lit = bytes(data[p + cmd_len:p + cmd_len + lit_len])
            raw = None
            chunk = deferred.flags_to_chunk(self._flags)
            if self.options.external_probs is None:
                # native line-speed decode; golden fallback per frame
                profile = FLAG_PROFILES.get(self._flags & 0b11)
                if profile is not None:
                    layout = ModelLayout(PROFILES[profile],
                                         lo_bucketed=chunk > 0)
                    raw = native.decode_metablock(cmd, lit, raw_len,
                                                  profile == "cm", layout,
                                                  chunk)
            if raw is None:
                if chunk:
                    raw = deferred.decode_metablock(cmd, lit, raw_len,
                                                    self.options, chunk)
                else:
                    raw = engine_np.decode_metablock(cmd, lit, raw_len,
                                                     self.options)
            self._crc = crc32c(raw, self._crc)
            self._out += raw
            del self._in[:p + cmd_len + lit_len]
            self._pos = 0
            return True

    def read(self, n: int = -1) -> bytes:
        self.needs_input = False
        while not self._eof and (n < 0 or len(self._out) < n):
            if not self._step():
                break
        if n < 0:
            n = len(self._out)
        out = bytes(self._out[:n])
        del self._out[:n]
        return out
