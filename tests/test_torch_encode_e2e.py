"""The port's device encode end to end on the CPU:
divans_tpu_torch.compress(device="cpu") runs the hybrid pipeline (up to
quality 10) or the uniform device lanes (quality 11) with each kernel's
plain version and must give the container bytes of the JAX package's
native.compress (and of its own device branches of jax_engine.compress,
run in Pallas interpret mode), byte for byte.  Inputs: the sorted
divans_tpu sources, a slice of the vendored dictionary and
numpy-seeded bytes."""
import glob
import os

import numpy as np
import pytest
import torch

from divans_tpu import native as jnative
from divans_tpu.codec import jax_engine
from divans_tpu.container import format as jfmt
from divans_tpu.ir import matcher as jmatcher
from divans_tpu.options import DivansOptions as JOptions

import divans_tpu_torch as port
from divans_tpu_torch import native
from divans_tpu_torch.codec import decode, encode
from divans_tpu_torch.ir import matcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(n: int, seed: int, binary: float = 0.2) -> bytes:
    """Text (the sorted divans_tpu sources) with a binary tail: half a
    dictionary slice, half seeded random bytes."""
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    d = open(os.path.join(REPO, "divans_tpu", "data", "rfc7932_dict.bin"),
             "rb").read()
    rng = np.random.default_rng(seed)
    k = int(n * binary) // 2
    start = int(rng.integers(0, len(text) - n))
    return (text[start:start + n - 2 * k] + d[70000 + seed:70000 + seed + k]
            + rng.integers(0, 256, k, dtype=np.uint8).tobytes())


def _compress(data: bytes, **kw):
    """(port bytes on the CPU, reference bytes, STATS of the port run)."""
    kw = dict(dict(chunk_nibbles=256), **kw)
    encode.reset_stats()
    got = port.compress(data, port.DivansOptions(**kw), device="cpu")
    return got, jnative.compress(data, JOptions(**kw)), dict(encode.STATS)


# decode.STATS's frame counts (it counts the lane groups beside them)
FRAMES = ("device_frames", "host_frames", "golden_frames")


def _n_frames(blob: bytes) -> int:
    return len(jfmt.deserialize(blob)[2])


def _stats(**counts):
    """encode.STATS with these counts, every other one 0."""
    return dict(dict.fromkeys(encode.STATS, 0), **counts)


@pytest.mark.parametrize("quality", [9, 10])
@pytest.mark.parametrize("mb", [1 << 13, 1 << 14, 1 << 15, 1 << 16])
def test_compress_matches_native(mb, quality):
    data = _corpus(70000, seed=mb.bit_length() + quality)
    got, ref, stats = _compress(data, metablock_size=mb, quality=quality)
    assert got == ref
    n = _n_frames(ref)
    assert stats == _stats(cmd_host=n, lit_device=n)


def test_frame_with_several_sub_streams():
    """A 64 KiB frame that is mostly random bytes holds more than SUB_LIT
    (32 KiB) literals: its lit field has several sub-stream lanes."""
    data = _corpus(60000, seed=11, binary=0.9)
    got, ref, stats = _compress(data, metablock_size=1 << 16)
    assert got == ref and stats["lit_device"] == 1
    lit = jfmt.deserialize(ref)[2][0].lit
    assert lit[0] >= 2, "expected a lit field with several sub-streams"


def test_no_mixing_matches_native():
    data = _corpus(50000, seed=12)
    got, ref, _stats = _compress(data, metablock_size=1 << 14,
                                 dynamic_context_mixing=0)
    assert got == ref


@pytest.mark.parametrize("kw", [dict(use_context_map=False),
                                dict(force_stride_value=4)],
                         ids=["stride_profile", "stride4"])
def test_other_profiles_code_literals_on_the_host(kw):
    """Frames outside the packed envelope (the stride and mix profiles)
    have their literals coded by the generic deferred pass, none on the
    host: the same bytes.  (The name is from when the host coded them.)"""
    data = _corpus(40000, seed=13)
    got, ref, stats = _compress(data, metablock_size=1 << 14, **kw)
    assert got == ref
    n = _n_frames(ref)
    assert stats == _stats(cmd_host=n, lit_generic=n)


def test_roundtrip_through_port_decode():
    data = _corpus(30000, seed=14)
    blob = port.compress(data, port.DivansOptions(metablock_size=1 << 14,
                                                  chunk_nibbles=256),
                         device="cpu")
    decode.reset_stats()
    assert port.decompress(blob, device="cpu") == data
    assert {k: decode.STATS[k] for k in FRAMES} == {
        "device_frames": _n_frames(blob), "host_frames": 0,
        "golden_frames": 0}
    assert decode.STATS["groups"] >= 1


def test_matches_reference_hybrid_device_encode(monkeypatch):
    """The JAX package's own hybrid pipeline (jax_engine._compress_hybrid,
    reached by making jax_engine believe it runs on a TPU: its Pallas
    kernels then run in interpret mode) gives the same bytes."""
    monkeypatch.setattr(jax_engine, "_on_tpu", lambda: True)
    data = _corpus(24000, seed=15)
    kw = dict(metablock_size=8192, chunk_nibbles=256)
    ref = jax_engine.compress(data, JOptions(**kw))
    assert port.compress(data, port.DivansOptions(**kw), device="cpu") == ref


@pytest.mark.parametrize("kw", [dict(use_context_map=False),
                                dict(force_stride_value=4)],
                         ids=["stride_profile", "stride4"])
def test_other_profiles_match_reference_hybrid_encode(monkeypatch, kw):
    """The reference's hybrid pipeline sends these profiles' literals to
    its XLA generic pass (jax_engine.py:890-904): the port's generic pass
    gives its bytes, and those of native.compress."""
    monkeypatch.setattr(jax_engine, "_on_tpu", lambda: True)
    data = _corpus(32000, seed=21)
    kw = dict(metablock_size=8192, chunk_nibbles=256, **kw)
    ref = jax_engine.compress(data, JOptions(**kw))
    assert ref == jnative.compress(data, JOptions(**kw))
    encode.reset_stats()
    assert port.compress(data, port.DivansOptions(**kw), device="cpu") == ref
    assert encode.STATS["lit_generic"] == _n_frames(ref)


def test_empty_input():
    opts = dict(chunk_nibbles=256)
    assert port.compress(b"", port.DivansOptions(**opts), device="cpu") == \
        jnative.compress(b"", JOptions(**opts))


def test_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.compress(b"abc" * 100, port.DivansOptions(chunk_nibbles=256))


def test_adaptive_profile_is_not_ported():
    """The adaptive profile (chunk_nibbles=0) once raised here; it now
    encodes through codec/adaptive (the per-nibble model pass and the
    rANS encode, plain versions on the CPU) to the reference's bytes.
    tests/test_torch_adaptive_e2e.py holds the rest of it."""
    data = b"abc" * 100
    assert port.compress(data, port.DivansOptions(chunk_nibbles=0),
                         device="cpu") == \
        jnative.compress(data, JOptions(chunk_nibbles=0))


# ------------------------------------------------------------ quality 11

@pytest.fixture(scope="module")
def dictionary_indexes():
    """Both packages' dictionary indexes, built once and single-threaded
    (the reference's build is not guarded by a lock, and its encode
    pool would build it once a thread)."""
    jmatcher._dict_flat_index()
    matcher._dict_flat_index()


@pytest.mark.parametrize("mb", [1 << 13, 1 << 15])
def test_q11_compress_matches_native(mb, dictionary_indexes):
    """Quality 11 takes the uniform device lanes: every frame's cmd
    stream and literals on the card's kernels (their plain versions
    here), the container of the reference's native.compress."""
    data = _corpus(70000, seed=mb.bit_length() + 11)
    got, ref, stats = _compress(data, metablock_size=mb, quality=11)
    assert got == ref
    n = _n_frames(ref)
    assert stats == _stats(cmd_device=n, lit_device=n)
    assert native.compress(data, port.DivansOptions(
        metablock_size=mb, quality=11, chunk_nibbles=256)) == ref


def test_q11_matches_reference_uniform_device_encode(monkeypatch,
                                                     dictionary_indexes):
    """The JAX package's own uniform branch (jax_engine.compress made to
    believe it runs on a TPU: the cmd pass then runs kernel 4 in
    interpret mode) gives the same bytes."""
    monkeypatch.setattr(jax_engine, "_on_tpu", lambda: True)
    data = _corpus(24000, seed=16)
    kw = dict(metablock_size=8192, chunk_nibbles=256, quality=11)
    ref = jax_engine.compress(data, JOptions(**kw))
    assert port.compress(data, port.DivansOptions(**kw), device="cpu") == ref


@pytest.mark.parametrize("kw", [dict(chunk_nibbles=0),
                                dict(force_stride_value=4),
                                dict(dynamic_context_mixing=0)],
                         ids=["adaptive", "stride4", "no_mixing"])
def test_q11_native_compress_matches_reference(kw, dictionary_indexes):
    data = _corpus(30000, seed=17)
    kw = dict(dict(metablock_size=1 << 14, chunk_nibbles=256, quality=11),
              **kw)
    assert native.compress(data, port.DivansOptions(**kw)) == \
        jnative.compress(data, JOptions(**kw))


def test_q11_mix_profile_codes_literals_on_the_host(dictionary_indexes):
    """A forced stride (the mix profile) keeps the cmd streams on the
    cmd pass and codes the literals with the generic deferred pass, none
    on the host: the same bytes.  (The name is from when the host coded
    them.)"""
    data = _corpus(30000, seed=18)
    got, ref, stats = _compress(data, metablock_size=1 << 14, quality=11,
                                force_stride_value=4)
    assert got == ref
    n = _n_frames(ref)
    assert stats == _stats(cmd_device=n, lit_generic=n)


def test_q11_roundtrip_through_port_decode(dictionary_indexes):
    data = _corpus(40000, seed=19)
    blob = port.compress(data, port.DivansOptions(
        metablock_size=1 << 14, chunk_nibbles=256, quality=11),
        device="cpu")
    decode.reset_stats()
    assert port.decompress(blob, device="cpu") == data
    assert {k: decode.STATS[k] for k in FRAMES} == {
        "device_frames": _n_frames(blob), "host_frames": 0,
        "golden_frames": 0}
    assert decode.STATS["groups"] >= 1


def test_q11_cmd_speeds_outside_the_contract_raise(monkeypatch,
                                                   dictionary_indexes):
    """A quality-11 frame whose cmd rows are not each at one speed is
    outside the cmd pass's contract: its cmd stream takes the generic
    deferred pass (jax_engine.py:670-675), the reference's bytes.  (The
    name is from when such a frame raised.)"""
    monkeypatch.setattr(encode.cmd_pass, "cmd_speeds_from_rows",
                        lambda ts, r: None)
    data = _corpus(20000, seed=20)
    got, ref, stats = _compress(data, metablock_size=8192, quality=11)
    assert got == ref
    n = _n_frames(ref)
    assert stats == _stats(cmd_generic=n, lit_device=n)
