"""The port without its native library, on the CPU (every kernel wrapper
runs its plain version): the reference's lib-less routes.  Both
packages' native.load is patched to return None, in these tests only.

The containers equal the reference's golden engine's byte for byte
(divans_tpu.api.compress(..., engine="golden") without the library: the
greedy parse, the Python dictionary scan, the Python trace FSM) at chunk
256 (quality 10 and 11), at chunk 0 and in the mix profile, and each
decodes to its input: the chunk-256 ones through the golden structure
pass (codec/deferred.CmdScript) feeding kernel 1's plain version and the
Python script executor, on the grouped pipeline and on the resumable
route.  The golden structure pass equals the reference's
(pallas_decode.decode_structures); the streaming adapters and the CLI
run without the library; with it, the containers are the native ones.
native.load caches a failed build (one build attempt from many threads,
one warning).  No XLA compile and no Pallas interpret run: the
reference's encode is its golden engine, its structure pass Python."""
import glob
import io
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from divans_tpu import api as japi
from divans_tpu import io_adapters as jio
from divans_tpu import native as jnative
from divans_tpu.codec import pallas_decode as jpd
from divans_tpu.codec.layout import ModelLayout as JLayout
from divans_tpu.codec.layout import PROFILES as JPROFILES
from divans_tpu.container import format as jfmt
from divans_tpu.ir import matcher as jmatcher
from divans_tpu.options import DivansOptions as JOptions

import divans_tpu_torch as port
from divans_tpu_torch import cli, native
from divans_tpu_torch.codec import decode, deferred, encode, lit_pass
from divans_tpu_torch.codec.deferred import flags_to_chunk
from divans_tpu_torch.codec.layout import ModelLayout, PROFILES
from divans_tpu_torch.container import format as fmt
from divans_tpu_torch.container.crc32c import crc32c_py
from divans_tpu_torch.errors import CorruptStream
from divans_tpu_torch.io_adapters import CompressorWriter, DecompressorReader
from divans_tpu_torch.ir import matcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = b"".join(open(f, "rb").read() for f in sorted(glob.glob(
    os.path.join(REPO, "divans_tpu", "**", "*.py"), recursive=True)))
MB = 1 << 12
LAYOUT = ModelLayout(PROFILES["cm"], lo_bucketed=True)
JLAYOUT = JLayout(JPROFILES["cm"], lo_bucketed=True)

# case: (options, input).  Chunk 0 stays at 1.5 KiB: its plain model
# pass and scan code a nibble at a time (~3 ms a byte here).
CASES = {
    "c256-q10": (dict(chunk_nibbles=256), TEXT[:8192]),
    "c256-q11": (dict(chunk_nibbles=256, quality=11), TEXT[20000:24096]),
    "c0": (dict(), TEXT[40000:41536]),
    "mix": (dict(chunk_nibbles=256, force_stride_value=4),
            TEXT[60000:68192]),
}


def _absent(mp: pytest.MonkeyPatch) -> None:
    """Both packages without their native library."""
    mp.setattr(native, "load", lambda: None)
    mp.setattr(jnative, "load", lambda: None)


@pytest.fixture
def no_native(monkeypatch):
    _absent(monkeypatch)


@pytest.fixture(scope="module")
def containers():
    """Each case's (input, port container, golden container), all made
    without the library; both dictionary indexes first, single-threaded
    (the reference's build is not guarded by a lock)."""
    jmatcher._dict_flat_index()
    matcher._dict_flat_index()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _absent(mp)
        for name, (kw, data) in CASES.items():
            golden = japi.compress(data, JOptions(metablock_size=MB, **kw),
                                   engine="golden")
            encode.reset_stats()
            blob = port.compress(data, port.DivansOptions(metablock_size=MB,
                                                          **kw),
                                 device="cpu")
            out[name] = (data, blob, golden, dict(encode.STATS))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_compress_equals_the_golden_engine(containers, case):
    """The port's lib-less container is the reference's golden engine's;
    at chunk 256 every frame's streams went to the card's lanes (no
    hybrid: no cmd stream on the host)."""
    data, blob, golden, stats = containers[case]
    assert blob == golden
    if CASES[case][0].get("chunk_nibbles"):
        n = len(fmt.deserialize(blob)[2])
        assert stats["cmd_host"] == 0
        assert stats["cmd_device"] + stats["cmd_generic"] == n
        assert stats["lit_device"] + stats["lit_generic"] == n
        if case != "mix":     # the bucketed cm profile: kernel 3's packing
            assert stats["lit_device"] == n


@pytest.mark.parametrize("case", ["c256-q10", "c0", "mix"])
def test_decompress_returns_the_input(containers, no_native, case):
    """Each container through divans_tpu_torch.decompress without the
    library: at chunk 256 (cm) the golden structure pass, kernel 1 and
    the Python executor (every frame on the lane kernel); the mix
    profile's frames and the scan's flagged frames on the golden
    engine.  The host-only decode (native.decompress) agrees."""
    data, blob, _g, _s = containers[case]
    decode.reset_stats()
    assert port.decompress(blob, device="cpu") == data
    if case == "c256-q10":
        n = len(fmt.deserialize(blob)[2])
        assert {k: decode.STATS[k] for k in
                ("device_frames", "host_frames", "golden_frames")} == {
            "device_frames": n, "host_frames": 0, "golden_frames": 0}
        assert decode.STATS["groups"] >= 1
    assert native.decompress(blob) == data


def test_resumable_route_runs_cmd_scripts(containers, no_native,
                                          monkeypatch):
    """The quality-11 container (dictionary words among the script's
    ops) through the segment pipeline: CmdScripts' literals decoded by
    kernel 1 resumed segment after segment, then executed in Python."""
    data, blob, _g, _s = containers["c256-q11"]
    _w, _mb, frames, _crc, flags = fmt.deserialize(blob)
    scripts = []
    real = decode.execute

    def spy(script, lit_bytes, out):
        scripts.append(script)
        return real(script, lit_bytes, out)

    monkeypatch.setattr(decode, "execute", spy)
    decode.reset_stats()
    raw = decode.decompress_frames(frames, flags_to_chunk(flags), LAYOUT,
                                   "cpu", resume=True, seg_steps=6,
                                   seg_chunks=1)
    assert raw == data
    assert decode.STATS["device_frames"] == len(frames)
    assert len(scripts) == len(frames)
    assert all(isinstance(s, deferred.CmdScript) for s in scripts)
    assert any(op[0] == "D" for s in scripts for op in s.ops)


def _norm(sc):
    ops = [(op[0], bytes(op[1])) if op[0] == "D" else tuple(op)
           for op in sc.ops]
    return (ops, sc.lit_total, list(sc.lcmap),
            [(s.inc, s.lim) for s in sc.speeds], bool(sc.supported))


@pytest.mark.parametrize("case", ["c256-q10", "c256-q11"])
def test_golden_structure_pass_equals_the_reference(containers, no_native,
                                                    case):
    """decode.decode_structures without the library: each frame's
    CmdScript equals the reference's pallas_decode.decode_structures
    script (ops, lit_total, lcmap, speeds, supported), and
    deferred.execute_script over the frame's literal bytes reproduces
    the frame."""
    data, blob, _g, _s = containers[case]
    frames = fmt.deserialize(blob)[2]
    chunk = flags_to_chunk(fmt.deserialize(blob)[4])
    got = decode.decode_structures(frames, chunk, LAYOUT)
    want = jpd.decode_structures(jfmt.deserialize(blob)[2], chunk, JLAYOUT,
                                 JOptions())
    assert got is not None and want is not None
    off = 0
    for f, g, w in zip(frames, got, want):
        assert isinstance(g, deferred.CmdScript)
        assert _norm(g) == _norm(w)
        raw = data[off:off + f.raw_len]
        lits, pos = bytearray(), 0
        for op in g.ops:
            if op[0] == "L":
                lits += raw[pos:pos + op[1]]
                pos += op[1]
            else:
                pos += op[2] if op[0] == "C" else len(op[1])
        assert deferred.execute_script(g, bytes(lits)) == raw
        off += f.raw_len


def test_short_literals_raise_coded_error(containers, no_native):
    """A CmdScript given fewer literal bytes than its ops take does not
    fill its frame: decode.execute raises CorruptStream."""
    data, blob, _g, _s = containers["c256-q10"]
    f = fmt.deserialize(blob)[2][0]
    sc = decode.decode_structure(f, 256, LAYOUT)
    out = np.empty(f.raw_len, np.uint8)
    with pytest.raises(CorruptStream):
        decode.execute(sc, b"\0" * (sc.lit_total - 1), out)


def test_streaming_adapters(no_native):
    """The writer's bytes equal the reference's lib-less writer's (the
    golden engine a frame), and the reader returns the input."""
    data = TEXT[80000:88192]
    sinks = []
    for writer in (CompressorWriter, jio.CompressorWriter):
        sink = io.BytesIO()
        opts = (port.DivansOptions if writer is CompressorWriter
                else JOptions)(metablock_size=MB)
        w = writer(sink, opts)
        w.write(data[:5000])
        w.write(data[5000:])
        w.close()
        sinks.append(sink.getvalue())
    assert sinks[0] == sinks[1]
    assert DecompressorReader(io.BytesIO(sinks[0])).read() == data


def test_cli_compress_and_decompress(no_native, tmp_path):
    """The CLI's -c (-deferred) gives the golden engine's container and
    -d returns the input, without the library."""
    data = TEXT[100000:101536]
    src, mid, back = (tmp_path / n for n in ("in", "mid", "back"))
    src.write_bytes(data)
    assert cli.main(["-c", "-deferred", str(src), str(mid)],
                    device="cpu") == 0
    assert mid.read_bytes() == japi.compress(
        data, JOptions(chunk_nibbles=256), engine="golden")
    assert cli.main(["-d", str(mid), str(back)], device="cpu") == 0
    assert back.read_bytes() == data


def test_library_present_keeps_native_containers(containers):
    """With the library the encode is the native one (the optimal parse,
    the hybrid: every cmd stream coded on the host), equal to the
    reference's native.compress, and differs from the lib-less one."""
    data, lib_less, _g, _s = containers["c256-q10"]
    opts = dict(metablock_size=MB, chunk_nibbles=256)
    encode.reset_stats()
    blob = port.compress(data, port.DivansOptions(**opts), device="cpu")
    assert blob == jnative.compress(data, JOptions(**opts))
    assert encode.STATS["cmd_host"] == len(fmt.deserialize(blob)[2])
    assert blob != lib_less


def test_pack_lit_row_is_native_pack_lit(containers):
    """lit_pass.pack_lit_row (the lib-less packing for kernel 3) equals
    native.pack_lit on the optimal parse's and the greedy parse's
    traces, and refuses what it refuses."""
    data = CASES["c256-q10"][1]
    opts = port.DivansOptions(chunk_nibbles=256)
    lit_base = LAYOUT.segments["lit_hi"][0]
    traces = [native.build_trace(data, opts, LAYOUT)]
    with pytest.MonkeyPatch.context() as mp:
        _absent(mp)
        traces.append(encode.frame_trace(data, opts, LAYOUT))
    for t in traces:
        want = native.pack_lit(t, lit_base)
        (_c,), (lit_t,), *_ = encode.split_stream_traces([t], LAYOUT)
        got = lit_pass.pack_lit_row(lit_t)
        assert np.array_equal(got[0], want[0]) and got[0].dtype == np.uint16
        assert np.array_equal(got[1], want[1])
        dead = t.copy()
        dead[np.flatnonzero(t[:, 2] == 1)[0], 3:6] = 0
        (_c,), (lit_d,), *_ = encode.split_stream_traces([dead], LAYOUT)
        assert native.pack_lit(dead, lit_base) is None
        assert lit_pass.pack_lit_row(lit_d) is None
        assert lit_pass.pack_lit_row(lit_t[:-1]) is None


def test_failed_build_is_cached_and_warned(monkeypatch, tmp_path):
    """A library that cannot be built: one build attempt however many
    threads ask, one warning carrying the build's message, then None
    from load() and from the wrappers (crc32c computes in Python)."""
    calls = []

    def failing_make(args, **_kw):
        calls.append(args)
        return subprocess.CompletedProcess(args, 2, "", "no compiler here")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SO", str(tmp_path / "absent.so"))
    monkeypatch.setattr(native.subprocess, "run", failing_make)
    with pytest.warns(RuntimeWarning, match="no compiler here") as rec:
        with ThreadPoolExecutor(8) as ex:
            got = list(ex.map(lambda _i: native.load(), range(16)))
    assert got == [None] * 16 and len(calls) == 1 and len(rec) == 1
    assert native.load() is None and len(calls) == 1
    assert native.crc32c(TEXT[:999], 7) == crc32c_py(TEXT[:999], 7)
    assert native.find_matches(TEXT[:999], 9) is None
    assert native.decode_metablock(b"", b"", 0, True, LAYOUT) is None
