"""The port's golden engine against the JAX package's: the serial rANS
coder, the scalar CDF helpers, the adaptive engine (codec/engine_np),
the golden deferred codec (codec/deferred), the Python trace FSM
(codec/trace) and the host-only native decompress, byte for byte both
ways; and the decode routes that reach the golden engine: frames native
code refuses (adaptive and deferred), ECDF containers, flags that name
no profile.  Inputs: the sorted divans_tpu sources and numpy-seeded
bytes, 8-32 KiB."""
import dataclasses
import glob
import os

import numpy as np
import pytest

from divans_tpu.ans import coder_np as jcoder
from divans_tpu.codec import deferred as jdeferred
from divans_tpu.codec import engine_np as jeng
from divans_tpu.codec import jax_engine
from divans_tpu.codec import layout as jlayout
from divans_tpu.codec import trace as jtrace
from divans_tpu.container import format as jfmt
from divans_tpu.errors import CodedError as JCodedError
from divans_tpu.ir import commands as jcmds
from divans_tpu.ir import matcher as jmatcher
from divans_tpu.options import DivansOptions as JOptions
from divans_tpu.probability import blend_cdf as jblend
from divans_tpu.probability import external_cdf as jext
from divans_tpu.probability import scalar as jscalar

import divans_tpu_torch as port
from divans_tpu_torch import native
from divans_tpu_torch.ans import coder_np
from divans_tpu_torch.codec import (adaptive, decode, deferred, engine_np,
                                    layout, trace)
from divans_tpu_torch.container import format as fmt
from divans_tpu_torch.errors import CodedError
from divans_tpu_torch.ir import commands as cmds
from divans_tpu_torch.ir import matcher
from divans_tpu_torch.probability import blend_cdf, external_cdf, scalar
from divans_tpu_torch.probability.speed import Speed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FILES = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                          recursive=True))
TEXT = b"".join(open(f, "rb").read() for f in _FILES)


def _data(n: int, seed: int) -> bytes:
    """Text (the sorted divans_tpu sources) with a seeded binary tail."""
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(TEXT) - n))
    k = n // 8
    return TEXT[start:start + n - k] + rng.integers(
        0, 256, k, dtype=np.uint8).tobytes()


def _both(kw: dict):
    return port.DivansOptions(**kw), JOptions(**kw)


@pytest.fixture(scope="module")
def dictionary_indexes():
    """Both packages' dictionary indexes, built once and single-threaded
    (the reference's build is not guarded by a lock)."""
    jmatcher._dict_flat_index()
    matcher._dict_flat_index()


# ------------------------------------------------------------ primitives

def test_ans_coder_matches_reference():
    rng = np.random.default_rng(11)
    pairs = []
    for _ in range(3000):
        start = int(rng.integers(0, 1 << 15))
        freq = int(rng.integers(1, (1 << 15) - start + 1))
        pairs.append((start, freq))
    enc, jenc = coder_np.ANSEncoder(), jcoder.ANSEncoder()
    for s, f in pairs:
        enc.put(s, f)
        jenc.put(s, f)
    blob, marks = enc.flush_with_marks()
    assert (blob, marks) == jenc.flush_with_marks()
    dec = coder_np.ANSDecoder(blob[:10])
    dec.extend(blob[10:])
    for s, f in pairs:
        off = dec.peek_offset()
        assert s <= off < s + f
        dec.advance(s, f)


@pytest.mark.parametrize("fn", ["blend", "average", "start_freq", "offset",
                                "blend_cdf", "weights", "external"])
def test_scalar_helpers_match_reference(fn):
    rng = np.random.default_rng(12)
    for _ in range(200):
        cdf = np.cumsum(rng.integers(1, 600, 16)).tolist()
        other = np.cumsum(rng.integers(1, 600, 16)).tolist()
        sym = int(rng.integers(0, 16))
        if fn == "blend":
            a, b = list(cdf), list(cdf)
            inc, lim = int(rng.integers(1, 400)), int(rng.integers(1, 9000))
            scalar.blend(a, sym, inc, lim)
            jscalar.blend(b, sym, inc, lim)
            assert a == b
        elif fn == "average":
            w = int(rng.integers(0, 1 << 15))
            assert scalar.average(cdf, other, w) == \
                jscalar.average(cdf, other, w)
        elif fn == "start_freq":
            assert scalar.sym_to_start_freq(cdf, sym) == \
                jscalar.sym_to_start_freq(cdf, sym)
        elif fn == "offset":
            off = int(rng.integers(0, 1 << 15))
            assert scalar.offset_to_sym(cdf, off) == \
                jscalar.offset_to_sym(cdf, off)
        elif fn == "blend_cdf":
            st, jst = blend_cdf.fresh(), jblend.fresh()
            for v in rng.integers(0, 16, 40).tolist():
                st = blend_cdf.blend(*st, v)
                jst = jblend.blend(*jst, v)
                for a, b in zip(st, jst):
                    np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(blend_cdf.cdf_lookup(st[0], sym),
                                          jblend.cdf_lookup(jst[0], sym))
            np.testing.assert_array_equal(blend_cdf.pdf(st[0], sym),
                                          jblend.pdf(jst[0], sym))
        elif fn == "weights":
            w, jw = [1 << 16, 1 << 17, 0], [1 << 16, 1 << 17, 0]
            p0, p1 = int(rng.integers(1, 1 << 15)), int(rng.integers(1, 1 << 15))
            pw = int(rng.integers(1, 1 << 15))
            scalar.weights_update(w, p0, p1, pw)
            jscalar.weights_update(jw, p0, p1, pw)
            assert w == jw
            assert scalar.norm_weight(w[0], w[1]) == \
                jscalar.norm_weight(jw[0], jw[1])
        else:
            probs = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
            assert list(external_cdf.external_prob_cdf(probs)) == \
                list(jext.external_prob_cdf(probs))


# ------------------------------------------------------ the golden engine

ENGINE_CASES = {
    "adaptive": {}, "deferred256": dict(chunk_nibbles=256),
    "q5": dict(quality=5), "deferred64_q7": dict(quality=7,
                                                 chunk_nibbles=64),
    "cmap8": dict(cmap_clustering=8), "streamed": dict(
        streaming_chunk_bytes=2048),
    "stride": dict(use_context_map=False, chunk_nibbles=128),
}


@pytest.mark.parametrize("kw", ENGINE_CASES.values(), ids=ENGINE_CASES)
def test_engine_np_matches_reference_both_ways(kw):
    """engine_np.compress gives the reference's bytes, and each package's
    engine_np.decompress decodes the other's container."""
    data = _data(12000, seed=21)
    opts, jopts = _both(dict(metablock_size=1 << 12, **kw))
    blob = engine_np.compress(data, opts)
    assert blob == jeng.compress(data, jopts)
    assert engine_np.decompress(blob, opts) == data
    assert jeng.decompress(blob, jopts) == data


@pytest.mark.parametrize("chunk", [64, 256])
def test_deferred_codec_matches_reference_both_ways(chunk,
                                                    dictionary_indexes):
    """The golden deferred codec on one frame's command list (quality 11:
    dict commands; a cmd and a distance block switch, which native code
    refuses): the reference's streams, and each decodes the other's."""
    data = _data(16000, seed=22)
    jcommands = jmatcher.build_commands(data, JOptions(quality=11))
    jcommands[1:1] = [jcmds.BlockSwitchCommand(1),
                      jcmds.BlockSwitchDistance(1)]
    commands = _port_commands(jcommands)
    opts = port.DivansOptions(quality=11)
    got = deferred.encode_metablock(data, commands, opts, chunk)
    ref = jdeferred.encode_metablock(data, jcommands, JOptions(quality=11),
                                     chunk)
    assert got == ref
    assert deferred.decode_metablock(*ref, len(data), opts, chunk) == data
    lay = layout.ModelLayout(layout.PROFILES["cm"], lo_bucketed=True)
    assert native.decode_metablock(ref[0], ref[1], len(data), True, lay,
                                   chunk) is None


def _port_commands(jcommands):
    """The reference's command objects as the port's (same fields)."""
    out = []
    for c in jcommands:
        f = {k.name: getattr(c, k.name) for k in dataclasses.fields(c)}
        if "speeds" in f:
            f["speeds"] = tuple(Speed(s.inc, s.lim) for s in f["speeds"])
        out.append(getattr(cmds, type(c).__name__)(**f))
    return out


@pytest.mark.parametrize("profile,kw", [
    ("cm", dict(quality=11)), ("stride", dict(quality=11,
                                              use_context_map=False)),
    ("mix", dict(force_stride_value=3)), ("cm", dict(quality=4))],
    ids=["q11_cm", "q11_stride", "mix", "q4"])
@pytest.mark.parametrize("bucketed", [False, True], ids=["adaptive",
                                                         "deferred"])
def test_python_trace_matches_reference(profile, kw, bucketed,
                                        dictionary_indexes):
    """codec/trace.build_trace_with_bounds equals the reference's on the
    same command list, and the native FSM's trace where it takes the
    list."""
    data = _data(9000, seed=23)
    opts, jopts = _both(kw)
    jcommands = jmatcher.build_commands(data, jopts)
    commands = matcher.build_commands(data, opts)
    assert commands == _port_commands(jcommands)
    lay = layout.ModelLayout(layout.PROFILES[profile], lo_bucketed=bucketed)
    jlay = jlayout.ModelLayout(jlayout.PROFILES[profile],
                               lo_bucketed=bucketed)
    got, bounds = trace.build_trace_with_bounds(data, commands, opts, lay)
    ref, jbounds = jtrace.build_trace_with_bounds(data, jcommands, jopts,
                                                  jlay)
    np.testing.assert_array_equal(got, ref)
    assert bounds == jbounds
    nat = native.build_trace_cmds(data, commands, opts, lay)
    if nat is not None:
        np.testing.assert_array_equal(nat, got)


# ------------------------------------------------ decodes on the golden path

def _golden_container(chunk: int, seed: int) -> tuple[bytes, bytes]:
    """A two-frame container the reference's golden engine writes from
    command lists with a cmd block switch, which native code refuses."""
    data = _data(8192, seed=seed)
    jopts = JOptions()
    frames = []
    for off in (0, 4096):
        raw = data[off:off + 4096]
        jc = jmatcher.build_commands(raw, jopts)
        jc[1:1] = [jcmds.BlockSwitchCommand(1)]
        if chunk:
            cmd_b, lit_b = jdeferred.encode_metablock(raw, jc, jopts, chunk)
        else:
            cmd_b, lit_b = jeng.encode_metablock(raw, jc, jopts)
        frames.append(jfmt.MetablockFrame(len(raw), cmd_b, lit_b))
    blob = jfmt.serialize(frames, 22, 12, native.crc32c(data),
                          flags=jdeferred.chunk_to_flags(chunk))
    return data, blob


@pytest.mark.parametrize("chunk", [0, 256], ids=["adaptive", "deferred"])
def test_frames_native_refuses_decode_on_golden(chunk):
    data, blob = _golden_container(chunk, seed=24)
    adaptive.reset_stats()
    decode.reset_stats()
    assert port.decompress(blob, device="cpu") == data
    stats = decode.STATS if chunk else adaptive.STATS
    assert stats["golden_frames"] == 2, stats
    assert native.decompress(blob) == data


def _ecdf(n: int, seed: int) -> bytes:
    """External per-bit probabilities, 8 bytes a raw byte (seeded)."""
    return np.random.default_rng(seed).integers(
        1, 256, 8 * n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("chunk", [0, 256], ids=["adaptive", "deferred"])
def test_ecdf_container_round_trips_with_options(chunk):
    """An ECDF container (the literals coded against the caller's
    probabilities) equals the reference's and decodes with options=."""
    data = _data(9000, seed=25)
    kw = dict(metablock_size=1 << 12, chunk_nibbles=chunk,
              external_probs=_ecdf(len(data), 26))
    opts, jopts = _both(kw)
    from divans_tpu import api as japi
    blob = port.compress(data, opts, device="cpu")
    assert blob == japi.compress(data, jopts)
    stats = decode.STATS if chunk else adaptive.STATS
    stats["golden_frames"] = 0
    assert port.decompress(blob, device="cpu", options=opts) == data
    assert stats["golden_frames"] == 3


def test_unknown_flags_decode_as_reference():
    """Flags that name no adaptive profile: jax_engine.decompress sends
    the container to its golden engine; the port decodes it the same way
    (or raises a CodedError of the same code)."""
    data = _data(4400, seed=27)
    blob = native.compress(data, port.DivansOptions(metablock_size=1 << 12))
    outs = []
    for bit in (0x80, 0x40):
        bad = bytearray(blob)
        bad[6] |= bit            # header byte 6: the flags
        try:
            ref = ("ok", jax_engine.decompress(bytes(bad)))
        except JCodedError as e:
            ref = ("err", int(e.code))
        try:
            adaptive.reset_stats()
            got = ("ok", port.decompress(bytes(bad), device="cpu"))
            assert adaptive.STATS["golden_frames"] == 2
        except CodedError as e:
            got = ("err", int(e.code))
        assert got == ref
        outs.append(got)
    assert outs[0] == ("ok", data)


def test_native_decompress_matches_reference(dictionary_indexes):
    """The host-only decompress: every frame through native code, the
    golden engine where it refuses (a mix of both in one container)."""
    data, blob = _golden_container(0, seed=28)
    assert native.decompress(blob) == data
    plain = port.compress(_data(9000, seed=29), port.DivansOptions(
        metablock_size=1 << 12, quality=11, chunk_nibbles=256),
        device="cpu")
    assert native.decompress(plain) == _data(9000, seed=29)
    with pytest.raises(CodedError):
        native.decompress(plain[:40] + bytes([plain[40] ^ 0x20])
                          + plain[41:])


@pytest.mark.parametrize("chunk", [0, 256], ids=["adaptive", "deferred"])
def test_corrupt_golden_frame_raises_coded_error(chunk):
    """Flipped bits in frames that only the golden engine decodes: each a
    CodedError (a corrupt stream, or bytes the CRC rejects), never
    another exception (where the reference's golden engine raises an
    AssertionError for a decoded speed out of range, or StopIteration for
    literals past the last lit sub-stream, the port raises CorruptStream)."""
    data, blob = _golden_container(chunk, seed=30)
    frames = jfmt.deserialize(blob)[2]
    rng = np.random.default_rng(31)
    for k in range(6):
        payload = getattr(frames[k % 2], ("cmd", "lit")[k % 3 == 2])
        bad = bytearray(blob)
        bad[blob.index(payload) + int(rng.integers(4, 40))] ^= \
            1 << int(rng.integers(0, 8))
        with pytest.raises(CodedError):
            port.decompress(bytes(bad), device="cpu")
