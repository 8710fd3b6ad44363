"""The port's streaming adapters (divans_tpu_torch/io_adapters.py): the
cases of tests/test_io_adapters.py, the writer's bytes against
divans_tpu.io_adapters.CompressorWriter's, streamed frames with the
latency and flush checks of tests/test_streaming.py on seeded text, and
a deferred container read by the reader.  The adapters run on the host
only."""
import glob
import io
import os

import numpy as np
import pytest

from divans_tpu import io_adapters as jio
from divans_tpu.ir import matcher as jmatcher
from divans_tpu.options import DivansOptions as JOptions

import divans_tpu_torch as port
from divans_tpu_torch import io_adapters as pio
from divans_tpu_torch.codec import engine_np
from divans_tpu_torch.io_adapters import CompressorWriter, DecompressorReader
from divans_tpu_torch.ir import matcher
from divans_tpu_torch.options import DivansOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = b"".join(open(f, "rb").read() for f in sorted(glob.glob(
    os.path.join(REPO, "divans_tpu", "**", "*.py"), recursive=True)))


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(TEXT) - n))
    return TEXT[start:start + n]


@pytest.fixture(scope="module")
def dictionary_indexes():
    """Both packages' dictionary indexes, built once and single-threaded
    (the reference's build is not guarded by a lock)."""
    jmatcher._dict_flat_index()
    matcher._dict_flat_index()


def _write(mod, opts, data: bytes, chunk: int) -> bytes:
    sink = io.BytesIO()
    w = mod.CompressorWriter(sink, opts)
    for off in range(0, len(data), chunk):
        w.write(data[off:off + chunk])
    w.flush_final()
    return sink.getvalue()


def _read(blob: bytes, opts, read_chunk: int) -> bytes:
    r = DecompressorReader(io.BytesIO(blob), opts)
    out = bytearray()
    while True:
        piece = r.read(read_chunk)
        if not piece:
            break
        out += piece
    return bytes(out)


def _stream_roundtrip(data, chunk, read_chunk, opts):
    blob = _write(pio, opts, data, chunk)
    # the container decodes through the one-shot decoder
    assert port.decompress(blob, device="cpu") == data
    return blob, _read(blob, opts, read_chunk)


@pytest.mark.parametrize("chunk,read_chunk", [(1, 7), (777, 1024), (65536, 3)])
def test_streaming_roundtrip(chunk, read_chunk):
    data = b"streaming all the way down, " * 300
    opts = DivansOptions(metablock_size=4096)
    blob, out = _stream_roundtrip(data, chunk, read_chunk, opts)
    assert out == data


def test_streaming_matches_oneshot():
    data = b"one shot equals streaming " * 400
    opts = DivansOptions(metablock_size=4096)
    blob, out = _stream_roundtrip(data, 999, 512, opts)
    assert blob == engine_np.compress(data, opts)


def test_streaming_crc_detects_corruption():
    data = b"check me " * 500
    opts = DivansOptions(metablock_size=4096)
    blob, _ = _stream_roundtrip(data, 100, 100, opts)
    bad = bytearray(blob)
    bad[20] ^= 1
    r = DecompressorReader(io.BytesIO(bytes(bad)), opts)
    with pytest.raises(Exception):
        while r.read(1024):
            pass


def test_empty_stream():
    sink = io.BytesIO()
    w = CompressorWriter(sink, DivansOptions())
    w.flush_final()
    r = DecompressorReader(io.BytesIO(sink.getvalue()))
    assert r.read(-1) == b""


def test_write_after_close_raises():
    w = CompressorWriter(io.BytesIO(), DivansOptions())
    w.flush_final()
    with pytest.raises(ValueError):
        w.write(b"x")


def test_mid_stream_flush():
    """flush() makes every byte written so far decodable at once."""
    data = _text(30000, seed=1)
    sink = io.BytesIO()
    w = CompressorWriter(sink, DivansOptions(metablock_size=8192))
    w.write(data[:5000])
    w.flush()                     # mid-stream: not at a metablock boundary
    assert sink.tell() > 16       # header + one short frame emitted
    r = DecompressorReader(io.BytesIO(sink.getvalue()), partial=True)
    assert r.read() == data[:5000]
    w.write(data[5000:])
    w.flush_final()
    r2 = DecompressorReader(io.BytesIO(sink.getvalue()))
    assert r2.read() == data


# name: options of both writers.  Writes of 3,000 bytes, so frames end
# inside a write and between writes.
WRITERS = {
    "defaults": dict(metablock_size=4096),
    "q9_nocm": dict(metablock_size=4096, quality=9, use_context_map=False),
    "q11": dict(metablock_size=8192, quality=11),
    "streamed": dict(metablock_size=8192, streaming_chunk_bytes=2048),
}


@pytest.mark.parametrize("name", WRITERS)
def test_writer_matches_reference(name, dictionary_indexes):
    data = _text(20000, seed=len(name))
    kw = WRITERS[name]
    blob = _write(pio, DivansOptions(**kw), data, 3000)
    assert blob == _write(jio, JOptions(**kw), data, 3000)
    assert _read(blob, DivansOptions(**kw), 4096) == data


class _CountingSource:
    """Feeds the container a slice at a time, counting consumption."""

    def __init__(self, blob, feed=4096):
        self.blob = blob
        self.pos = 0
        self.feed = feed

    def read(self, n):
        take = min(self.feed, n, len(self.blob) - self.pos)
        out = self.blob[self.pos:self.pos + take]
        self.pos += take
        return out


def test_reader_output_latency_bounded_by_chunk():
    """With streamed frames the reader yields output after a few chunks
    of input, though the whole stream is one metablock."""
    data = _text(48000, seed=2)
    chunk_raw = 1 << 12
    sink = io.BytesIO()
    w = CompressorWriter(sink, DivansOptions(
        streaming_chunk_bytes=chunk_raw, metablock_size=1 << 16))
    w.write(data)
    w.flush_final()
    blob = sink.getvalue()
    assert len(blob) < len(data)
    src = _CountingSource(blob, feed=512)
    r = DecompressorReader(src, partial=True)
    first = b""
    while not first:
        first = r.read(1 << 20)
        if not first:
            assert r.needs_input
            assert src.pos < len(blob), "consumed everything, no output"
    assert src.pos <= 4 * chunk_raw, (src.pos, len(blob))
    out = bytearray(first)
    while True:
        piece = r.read(1 << 20)
        if piece:
            out += piece
        elif r.needs_input:
            if src.pos >= len(blob):
                break
        else:
            break
    assert bytes(out) == data


def test_streamed_flush_and_multiframe():
    """Streamed frames compose with a mid-stream flush and several
    metablocks."""
    data = _text(30000, seed=3)
    sink = io.BytesIO()
    w = CompressorWriter(sink, DivansOptions(
        streaming_chunk_bytes=2048, metablock_size=1 << 13))
    w.write(data[:12000])
    w.flush()
    w.write(data[12000:])
    w.flush_final()
    blob = sink.getvalue()
    assert engine_np.decompress(blob) == data
    r = DecompressorReader(io.BytesIO(blob))
    assert r.read(-1) == data


def test_reader_takes_a_deferred_container():
    """A container of the card's deferred encode (here its plain
    versions), read a frame at a time."""
    data = _text(20000, seed=4)
    opts = port.DivansOptions(metablock_size=4096, chunk_nibbles=256)
    blob = port.compress(data, opts, device="cpu")
    assert _read(blob, opts, 5000) == data
