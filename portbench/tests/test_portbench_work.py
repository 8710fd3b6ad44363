"""The yardstick against the program on small inputs: the copied work
formulas against chip_smoke's, the reference's traces against the
program's, its frames and header against the program's containers, its
CRC32C against the host library's."""
import glob
import os
import sysconfig

import numpy as np
import pytest

from portbench import work
from portbench.reference import codec as ref

import chip_smoke
from divans_tpu_torch import api, native
from divans_tpu_torch.codec import adaptive
from divans_tpu_torch.codec.layout import ModelLayout, PROFILES
from divans_tpu_torch.container import format as fmt
from divans_tpu_torch.options import DivansOptions


def _sample(n: int, k: int) -> bytes:
    files = sorted(glob.glob(os.path.join(
        sysconfig.get_paths()["stdlib"], "*.py")))
    return b"".join(open(f, "rb").read() for f in files[k:k + 6])[:n]


BLOBS = [_sample(3000, 0), _sample(5000, 10),
         np.random.default_rng(1).integers(0, 256, 2500,
                                           np.uint8).tobytes(), b"ab"]


def test_traces_equal_the_programs():
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=False)
    for b in BLOBS:
        want = adaptive.frame_trace(b, DivansOptions(), layout)
        np.testing.assert_array_equal(ref.frame_trace(b, ref.DivansOptions()),
                                      want)


def test_work_formulas_equal_chip_smokes():
    ropts = ref.DivansOptions()
    traces = [ref.frame_trace(b, ropts) for b in BLOBS]
    assert work.model_pass_work(traces) == chip_smoke._model_pass_work(traces)
    frames = []
    for b in BLOBS:
        f = fmt.deserialize(native.compress(b, DivansOptions()))[2][0]
        frames.append(f)
    for wpos in ([f.raw_len for f in frames],
                 [f.raw_len // 2 for f in frames]):
        mine = [work.Frame(f.raw_len, f.cmd, f.lit) for f in frames]
        assert work.scan_work(mine, traces, wpos) == \
            chip_smoke._scan_work(frames, traces, np.array(wpos))
    assert work.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert work.INT32_OPS_PER_S == chip_smoke.INT32_OPS_PER_S


@pytest.mark.parametrize("i", range(len(BLOBS)))
def test_reference_equals_the_programs_container(i):
    b = BLOBS[i]
    ropts = ref.DivansOptions()
    blob = api.compress(b, DivansOptions(), device="cpu")
    got = ref.read_container(blob)
    want = ref.expected_header(b, ropts)
    assert {k: got[k] for k in want} == want
    assert got["frames"][0] == ref.encode_frame(b, ropts)


def test_crc32c_equals_the_host_librarys():
    rng = np.random.default_rng(3)
    for n in (0, 1, 4095, 4096, 4097, 3 * 4096 + 5, 100_000):
        d = rng.integers(0, 256, n, np.uint8).tobytes()
        assert ref.crc32c(d) == native.crc32c(d)


def test_reference_refuses_what_it_cannot_code():
    with pytest.raises(NotImplementedError):
        ref.encode_frame(b"abcd", ref.DivansOptions(chunk_nibbles=256))
