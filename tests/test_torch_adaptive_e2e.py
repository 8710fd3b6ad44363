"""The port's adaptive profile (chunk_nibbles=0, the default options) end
to end on the CPU: divans_tpu_torch.compress(device="cpu") runs
codec/adaptive's encode with each kernel's plain version and must give
the container bytes of the port's native.compress, the reference's
native.compress and the reference's jax_engine.compress; decompress
(device="cpu") runs the scan's plain version and must return the input
of those containers, with the frames the scan flags (quality 11's dict
commands) decoded on the host.  Inputs: the sorted divans_tpu sources,
numpy-seeded bytes."""
import glob
import os

import numpy as np
import pytest

from divans_tpu import native as jnative
from divans_tpu.codec import jax_engine
from divans_tpu.container import format as jfmt
from divans_tpu.ir import matcher as jmatcher
from divans_tpu.options import DivansOptions as JOptions

import divans_tpu_torch as port
from divans_tpu_torch import native
from divans_tpu_torch.codec import adaptive
from divans_tpu_torch.errors import CodedError
from divans_tpu_torch.ir import commands, matcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = 4096


def _data(n: int, seed: int) -> bytes:
    """Text (the sorted divans_tpu sources) with a seeded binary tail."""
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(text) - n))
    k = n // 8
    return text[start:start + n - k] + rng.integers(
        0, 256, k, dtype=np.uint8).tobytes()


def _roundtrip(blob: bytes) -> tuple[bytes, dict]:
    """The decode and adaptive.STATS after it, but for staging_grows (it
    depends on what this thread decoded before)."""
    adaptive.reset_stats()
    raw = port.decompress(blob, device="cpu")
    stats = dict(adaptive.STATS)
    del stats["staging_grows"]
    return raw, stats


@pytest.fixture(scope="module")
def dictionary_indexes():
    """Both packages' dictionary indexes, built once and single-threaded
    (the reference's build is not guarded by a lock)."""
    jmatcher._dict_flat_index()
    matcher._dict_flat_index()


@pytest.mark.parametrize("kw", [{}, dict(use_context_map=False)],
                         ids=["cm", "stride"])
def test_compress_matches_references(kw):
    """Two frames: the container of the port's native.compress, the
    reference's native.compress and jax_engine.compress, and back."""
    data = _data(MB + 1200, seed=len(kw))
    got = port.compress(data, port.DivansOptions(metablock_size=MB, **kw),
                        device="cpu")
    assert got == native.compress(data, port.DivansOptions(
        metablock_size=MB, **kw))
    assert got == jnative.compress(data, JOptions(metablock_size=MB, **kw))
    assert got == jax_engine.compress(data, JOptions(metablock_size=MB,
                                                     **kw))
    raw, stats = _roundtrip(got)
    assert raw == data
    assert stats == {"scan_frames": 2, "host_frames": 0, "golden_frames": 0,
                     "staged_calls": 1}


@pytest.mark.parametrize("data", [b"", b"\x00", bytes(range(256)) * 3],
                         ids=["empty", "one-byte", "ramp"])
def test_compress_small_inputs(data):
    got = port.compress(data, port.DivansOptions(), device="cpu")
    assert got == jnative.compress(data, JOptions())
    assert _roundtrip(got)[0] == data


def test_compress_incompressible():
    data = np.random.default_rng(9).integers(0, 256, 1800,
                                             dtype=np.uint8).tobytes()
    got = port.compress(data, port.DivansOptions(), device="cpu")
    assert got == jnative.compress(data, JOptions())
    assert len(got) > len(data)
    assert _roundtrip(got)[0] == data


def test_q11_compress_and_host_frames(dictionary_indexes):
    """Quality 11 (the matcher's command list, dict commands included,
    through the trace FSM): the reference's bytes; on the way back each
    frame whose commands hold a Dict leaves the scan for the host."""
    data = _data(MB + 1500, seed=5)
    opts = dict(metablock_size=MB, quality=11)
    got = port.compress(data, port.DivansOptions(**opts), device="cpu")
    assert got == jnative.compress(data, JOptions(**opts))
    with_dict = sum(
        any(isinstance(c, commands.Dict) for c in matcher.build_commands(
            data[o:o + MB], port.DivansOptions(**opts)))
        for o in range(0, len(data), MB))
    assert with_dict > 0
    raw, stats = _roundtrip(got)
    assert raw == data
    assert stats == {"scan_frames": 2 - with_dict, "host_frames": with_dict,
                     "golden_frames": 0, "staged_calls": 1}


def test_decompress_reference_mixing_container():
    """A container of the reference's native.compress at another mixer
    level decodes on the scan."""
    data = _data(2500, seed=6)
    blob = jnative.compress(data, JOptions(dynamic_context_mixing=2))
    assert _roundtrip(blob) == (data, {"scan_frames": 1, "host_frames": 0,
                                       "golden_frames": 0,
                                       "staged_calls": 1})


def test_corrupt_container_raises():
    """A flipped bit in a frame's cmd stream: the scan flags the frame,
    and the host decoders (native, then the golden engine) refuse it or
    decode bytes the CRC rejects: a CodedError either way."""
    data = _data(2500, seed=7)
    blob = port.compress(data, port.DivansOptions(), device="cpu")
    frame = jfmt.deserialize(blob)[2][0]
    bad = bytearray(blob)
    bad[blob.index(frame.cmd) + 9] ^= 0x10
    with pytest.raises(CodedError):
        port.decompress(bytes(bad), device="cpu")
