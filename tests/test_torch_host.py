"""The port's host modules against the JAX package's: container format,
CRC, layout, the torch int32 probability helpers against the numpy `xp`
versions, and the native compress byte for byte.  All bit-exact."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from divans_tpu import constants as jconstants
from divans_tpu import native as jnative
from divans_tpu.codec import deferred as jdeferred
from divans_tpu.codec import layout as jlayout
from divans_tpu.codec import pallas_decode as jpd
from divans_tpu.container import crc32c as jcrc
from divans_tpu.container import format as jfmt
from divans_tpu.options import DivansOptions as JOptions
from divans_tpu.probability import cdf16 as jcdf16
from divans_tpu.probability import weights as jweights

import divans_tpu_torch as port
from divans_tpu_torch import constants, native
from divans_tpu_torch.codec import decode, deferred, layout, lit_model
from divans_tpu_torch.container import crc32c, format as fmt
from divans_tpu_torch.errors import CodedError
from divans_tpu_torch.probability import cdf16, weights
from divans_tpu_torch.probability.speed import Speed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text(n: int) -> bytes:
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    return b"".join(open(f, "rb").read() for f in files)[:n]


def _binary(n: int, seed: int = 5) -> bytes:
    d = open(os.path.join(REPO, "divans_tpu", "data", "rfc7932_dict.bin"),
             "rb").read()
    rng = np.random.default_rng(seed)
    return (d[40000:40000 + n // 2]
            + rng.integers(0, 256, n - n // 2, dtype=np.uint8).tobytes())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


# ------------------------------------------------------------- container

def test_serialize_deserialize_match_reference():
    rng = np.random.default_rng(1)
    frames = [(int(rng.integers(0, 1 << 20)),
               rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes(),
               rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes()) for _ in range(7)]
    blob = fmt.serialize([fmt.MetablockFrame(*f) for f in frames], 22, 18,
                         0xDEADBEEF, flags=0b1001)
    ref = jfmt.serialize([jfmt.MetablockFrame(*f) for f in frames], 22, 18,
                         0xDEADBEEF, flags=0b1001)
    assert blob == ref
    w, mb, got, crc, flags = fmt.deserialize(ref)
    assert (w, mb, crc, flags) == (22, 18, 0xDEADBEEF, 0b1001)
    assert [(f.raw_len, f.cmd, f.lit) for f in got] == frames


@pytest.mark.parametrize("n", [0, 1, 127, 128, 300, 1 << 21, (1 << 35) + 3])
def test_varint_matches_reference(n):
    enc = fmt.write_varint(n)
    assert enc == jfmt.write_varint(n)
    assert fmt.read_varint(enc + b"x", 0) == jfmt.read_varint(enc + b"x", 0)


@pytest.mark.parametrize("mutate", ["magic", "version", "trailer", "eof"])
def test_corrupt_container_codes_match_reference(mutate):
    blob = bytearray(jnative.compress(_text(5000), JOptions(chunk_nibbles=256)))
    if mutate == "magic":
        blob[0] ^= 1
    elif mutate == "version":
        blob[4] = 9
    elif mutate == "trailer":
        blob[-1] ^= 1
    else:
        blob = blob[:40]
    with pytest.raises(CodedError) as got:
        fmt.deserialize(bytes(blob))
    with pytest.raises(jfmt.CorruptContainer) as ref:
        jfmt.deserialize(bytes(blob))
    assert int(got.value.code) == int(ref.value.code)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 65539])
def test_crc32c_matches_reference(n):
    data = _binary(n, seed=n)
    want = jcrc.crc32c(data)
    assert crc32c.crc32c(data) == want
    assert crc32c.crc32c_py(data) == want
    assert native.crc32c(data, 0x1234) == jcrc.crc32c(data, 0x1234)


def test_check_crc_raises_on_mismatch():
    fmt.check_crc(b"abc", jcrc.crc32c(b"abc"))
    with pytest.raises(fmt.CorruptContainer):
        fmt.check_crc(b"abd", jcrc.crc32c(b"abc"))


# ----------------------------------------------------- shared definitions

def test_constants_and_options_match_reference():
    for mode in range(4):
        assert np.array_equal(constants.literal_lut0(mode),
                              jconstants.literal_lut0(mode))
        assert np.array_equal(constants.literal_lut1(mode),
                              jconstants.literal_lut1(mode))
    assert [(f.name, f.default) for f in dataclasses.fields(port.DivansOptions)] \
        == [(f.name, f.default) for f in dataclasses.fields(JOptions)]
    assert np.array_equal(np.asarray(cdf16.CDF_INIT), jcdf16.CDF_INIT)
    assert np.array_equal(decode.lut_table()[:256], jconstants.literal_lut0(3))


@pytest.mark.parametrize("name", ["cm", "stride", "mix", "split"])
@pytest.mark.parametrize("bucketed", [False, True])
def test_layout_matches_reference(name, bucketed):
    a = layout.ModelLayout(layout.PROFILES[name], lo_bucketed=bucketed)
    b = jlayout.ModelLayout(jlayout.PROFILES[name], lo_bucketed=bucketed)
    assert a.segments == b.segments
    assert (a.num_rows, a.lo_shift) == (b.num_rows, b.lo_shift)
    assert np.array_equal(native._seg_array(a), jnative._seg_array(b))
    assert layout.PROFILE_FLAGS == jlayout.PROFILE_FLAGS


def test_kernel_perm_and_renorm_bound_match_reference():
    lay = layout.ModelLayout(layout.PROFILES["cm"], lo_bucketed=True)
    jlay = jlayout.ModelLayout(jlayout.PROFILES["cm"], lo_bucketed=True)
    perm, offs = lit_model.kernel_perm(lay)
    jperm, joffs = jpd.kernel_perm(jlay)
    assert np.array_equal(perm, jperm) and offs == joffs
    rng = np.random.default_rng(2)
    for _ in range(20):
        spd = rng.integers(0, 1 << 14, (3, 5, 6)).astype(np.int32)
        spd[..., 0::2] = rng.integers(0, 300, (3, 5, 3))
        for s in (32, 128, 512):
            assert (lit_model.renorm_bound_q(spd, s)
                    == jpd._renorm_bound_q(spd, s))


@pytest.mark.parametrize("chunk", [0, 16, 64, 256, 1024])
def test_chunk_flags_match_reference(chunk):
    assert deferred.chunk_to_flags(chunk) == jdeferred.chunk_to_flags(chunk)
    f = jdeferred.chunk_to_flags(chunk) | 0b10
    assert deferred.flags_to_chunk(f) == jdeferred.flags_to_chunk(f)


def test_lit_subs_split_matches_reference():
    subs = [b"", b"a" * 300, bytes(range(256)) * 3, b"xyz"]
    field = jdeferred.lit_subs_join(subs)
    assert deferred.lit_subs_split(field) == jdeferred.lit_subs_split(field)
    assert deferred.lit_subs_split(b"") == [b""]
    with pytest.raises(CodedError):
        deferred.lit_subs_split(b"\x03\x7f")


# ------------------------------------------- torch int32 probability math

EDGES = np.array([0, 1, 2, 3, 7, 8, 255, 256, 32767, 32768, 65535, 65536,
                  (1 << 24) - 1, 1 << 24, (1 << 30) - 1, 1 << 30,
                  (1 << 31) - 1], np.int64)


def test_bit_length_pos_matches_reference():
    rng = np.random.default_rng(3)
    x = np.concatenate([EDGES, rng.integers(0, 1 << 31, 5000)]).astype(np.int32)
    got = weights.bit_length_pos(_t(x)).numpy()
    assert np.array_equal(got, jweights._bit_length_pos(x))
    assert np.array_equal(got, jcdf16._bit_length_pos(x))
    neg = np.array([-1, -5, -(1 << 31)], np.int32)
    assert np.array_equal(weights.bit_length_pos(_t(neg)).numpy(),
                          jweights._bit_length_pos(neg))


def _weight_pairs(n=4000, seed=4):
    rng = np.random.default_rng(seed)
    w = np.concatenate([EDGES[1:16], rng.integers(1, 1 << 30, n)])
    w = np.clip(w, 1, (1 << 30) - 1).astype(np.int32)
    return w, np.roll(w, 7)


def test_fix_weights_matches_reference():
    w0, w1 = _weight_pairs()
    got = weights.fix_weights(_t(w0), _t(w1))
    ref = jweights._fix_weights(w0, w1)
    assert np.array_equal(got[0].numpy(), ref[0])
    assert np.array_equal(got[1].numpy(), ref[1])


def test_norm_weight_matches_reference():
    w0, w1 = _weight_pairs(seed=6)
    w0, w1 = jweights._fix_weights(w0, w1)
    got = weights.norm_weight(_t(w0), _t(w1)).numpy()
    assert np.array_equal(got, jweights.norm_weight(w0, w1))
    # the i16 wrap: equal weights give 1 << 14, w1 tiny gives a wrapped value
    assert weights.norm_weight(_t([1, 1 << 29]), _t([1, 1])).tolist() == \
        jweights.norm_weight(np.array([1, 1 << 29]), np.array([1, 1])).tolist()


def _cdfs(n, seed):
    """Valid CDFs: strictly increasing, max in [16, 32767]."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 2048, (n, 16))
    c = np.cumsum(steps, axis=1)
    c = (c * rng.integers(16, 32768, (n, 1)) // c[:, 15:16])
    c = np.maximum(c, np.arange(1, 17))
    for i in range(1, 16):
        c[:, i] = np.maximum(c[:, i], c[:, i - 1] + 1)
    c[:3] = jcdf16.CDF_INIT
    return c.astype(np.int32)


def test_average_matches_reference():
    a, b = _cdfs(3000, 7), _cdfs(3000, 8)
    rng = np.random.default_rng(9)
    mix = rng.integers(0, 1 << 15, 3000).astype(np.int32)
    mix[:4] = [0, 1 << 14, 1 << 15, 65535]
    got = cdf16.average(_t(a), _t(b), _t(mix)).numpy()
    assert np.array_equal(got, jcdf16.average(a, b, mix))
    assert np.array_equal(cdf16.average(_t(a), _t(b), 12345).numpy(),
                          jcdf16.average(a, b, 12345))


def test_start_freq_and_offset_to_sym_match_reference():
    c = _cdfs(4000, 10)
    rng = np.random.default_rng(11)
    off = rng.integers(0, 1 << 15, 4000).astype(np.int32)
    sym = jcdf16.offset_to_sym(c, off)
    assert np.array_equal(cdf16.offset_to_sym(_t(c), _t(off)).numpy(), sym)
    st, fr = cdf16.sym_to_start_freq(_t(c), _t(sym))
    rst, rfr = jcdf16.sym_to_start_freq(c, sym)
    assert np.array_equal(st.numpy(), rst) and np.array_equal(fr.numpy(), rfr)
    all_syms = np.stack([jcdf16.sym_to_start_freq(
        c, np.full(4000, s, np.int32))[1] for s in range(16)], axis=1)
    assert np.array_equal(cdf16.freqs_all(_t(c)).numpy(), all_syms)


def test_wrap_i16_matches_reference():
    x = np.array([-70000, -32769, -32768, -1, 0, 32767, 32768, 65535, 70000],
                 np.int32)
    assert np.array_equal(weights.wrap_i16(_t(x)).numpy(), jcdf16.wrap_i16(x))


# ------------------------------------------- native (host-only) compress

@pytest.mark.parametrize("quality", [9, 10])
@pytest.mark.parametrize("mb", [1 << 13, 1 << 14, 1 << 15, 1 << 16])
def test_compress_matches_reference(mb, quality):
    data = _text(70000) + _binary(30000) + _text(120000)[70000:]
    kw = dict(metablock_size=mb, chunk_nibbles=256, quality=quality)
    assert native.compress(data, port.DivansOptions(**kw)) == \
        jnative.compress(data, JOptions(**kw))


@pytest.mark.parametrize("kw", [
    dict(force_stride_value=4), dict(use_context_map=False),
    dict(chunk_nibbles=64, quality=5),
    dict(chunk_nibbles=0), dict(literal_adaptation=(
        Speed(16, 8192), Speed(32, 4096), Speed(8, 8192), Speed(2, 1024)))],
    ids=["stride4", "no_cmap", "chunk64_q5", "adaptive", "speeds"])
def test_compress_profiles_match_reference(kw):
    data = _text(40000) + _binary(8000)
    kw = dict(dict(metablock_size=1 << 14, chunk_nibbles=256), **kw)
    assert native.compress(data, port.DivansOptions(**kw)) == \
        jnative.compress(data, JOptions(**kw))
