"""The port's decode end to end on the CPU: containers made by the JAX
package's native compress (and by the port's own) come back as their
input through divans_tpu_torch.decompress(device="cpu"), with the cm
frames decoded on the device path (the lane decode with the kernels'
plain versions) and the other profiles on the host path."""
import glob
import os

import numpy as np
import pytest

from divans_tpu import native as jnative
from divans_tpu.container import format as jfmt
from divans_tpu.options import DivansOptions as JOptions

import divans_tpu_torch as port
from divans_tpu_torch.codec import adaptive, decode
from divans_tpu_torch.container.format import CorruptContainer
from divans_tpu_torch.errors import CodedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(n: int, seed: int) -> bytes:
    """In-repo text (the sorted JAX-package sources),
    a slice of the vendored dictionary and seeded random bytes."""
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    d = open(os.path.join(REPO, "divans_tpu", "data", "rfc7932_dict.bin"),
             "rb").read()
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(text) - n))
    k = n // 25
    return (text[start:start + n - 2 * k] + d[50000 + seed:50000 + seed + k]
            + rng.integers(0, 256, k, dtype=np.uint8).tobytes())


# decode.STATS's frame counts (it counts the lane groups beside them)
FRAMES = ("device_frames", "host_frames", "golden_frames")


def _decode(blob: bytes) -> bytes:
    decode.reset_stats()
    return port.decompress(blob, device="cpu")


@pytest.mark.parametrize("mb,size", [(1 << 13, 100000), (1 << 14, 140000),
                                     (1 << 15, 160000)])
def test_reference_container_roundtrips_on_device_path(mb, size):
    data = _corpus(size, seed=mb)
    blob = jnative.compress(data, JOptions(metablock_size=mb,
                                           chunk_nibbles=256))
    n_frames = len(jfmt.deserialize(blob)[2])
    assert _decode(blob) == data
    # every cm frame went through the lane decode, none to the host path
    assert {k: decode.STATS[k] for k in FRAMES} == {
        "device_frames": n_frames, "host_frames": 0, "golden_frames": 0}
    assert decode.STATS["groups"] >= 1


def test_port_compress_roundtrips():
    data = _corpus(60000, seed=3)
    blob = port.compress(data, port.DivansOptions(metablock_size=1 << 14,
                                                  chunk_nibbles=256),
                         device="cpu")
    assert _decode(blob) == data


@pytest.mark.parametrize("kw", [dict(force_stride_value=4),
                                dict(use_context_map=False)],
                         ids=["stride4", "no_cmap"])
def test_other_profiles_take_the_host_path(kw):
    data = _corpus(60000, seed=4)
    blob = jnative.compress(data, JOptions(metablock_size=1 << 14,
                                           chunk_nibbles=256, **kw))
    n_frames = len(jfmt.deserialize(blob)[2])
    assert _decode(blob) == data
    assert decode.STATS == {"device_frames": 0, "host_frames": n_frames,
                            "golden_frames": 0, "groups": 0,
                            "lane_chunks": 0, "slot_chunks": 0}


def test_empty_input_roundtrips():
    blob = port.compress(b"", port.DivansOptions(chunk_nibbles=256),
                         device="cpu")
    assert _decode(blob) == b""


def test_adaptive_container_is_not_ported():
    """A container of the reference's default options (the adaptive
    profile) once raised here; it now decodes through codec/adaptive (the
    scan, its plain version on the CPU), no frame on the host."""
    data = _corpus(5000, seed=6)
    blob = jnative.compress(data, JOptions())
    adaptive.reset_stats()
    assert _decode(blob) == data
    stats = dict(adaptive.STATS)
    assert stats.pop("staging_grows") <= 1
    assert stats == {"scan_frames": 1, "host_frames": 0,
                     "golden_frames": 0, "staged_calls": 1}


def test_corrupt_crc_raises():
    blob = bytearray(jnative.compress(_corpus(3000, seed=7),
                                      JOptions(chunk_nibbles=256)))
    blob[-5] ^= 0x40    # last crc byte
    with pytest.raises(CorruptContainer):
        _decode(bytes(blob))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corrupt_literals_raise(seed):
    """Flipped bits in a literal stream decode to wrong bytes (the word
    reads stay clamped to the lane's row) and end in a coded error, never
    a crash or a hang."""
    data = _corpus(30000, seed=8)
    blob = jnative.compress(data, JOptions(metablock_size=1 << 13,
                                           chunk_nibbles=256))
    _w, _mb, frames, _crc, _fl = jfmt.deserialize(blob)
    lit = frames[1].lit
    start = blob.index(lit)
    rng = np.random.default_rng(seed)
    bad = bytearray(blob)
    for pos in rng.integers(start + 8, start + len(lit), 4):
        bad[pos] ^= 1 << int(rng.integers(0, 8))
    with pytest.raises(CodedError):
        _decode(bytes(bad))
