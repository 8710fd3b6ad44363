"""The C API shim bound to the port (divans_tpu_torch/c): built with the
system compiler into divans_tpu_torch/_build/capi, then driven two ways.

(a) The example binary round-trips a payload cut from the repo's text
    (and checks that a corrupt magic and a flipped stored CRC fail with
    distinct codes).
(b) In a subprocess (a crash cannot take pytest down), ctypes.PyDLL drives
    libdivans_tpu_torch_capi.so inside a running interpreter: options set
    through divans_set_option for the three option dicts of
    tests/test_torch_capi_support.py, input fed in pieces and drained
    through a 100-byte buffer, so that both DIVANS_NEEDS_MORE_OUTPUT and
    DIVANS_NEEDS_MORE_INPUT occur.  The container equals what both
    packages' streaming adapters write for the same options, and
    divans_decode gives the payload back, the container fed whole and in
    777-byte pieces.
(c) A corrupt magic and a flipped stored CRC give DIVANS_FAILURE with
    divans_last_error_code 10 and 19.

The shim decodes through the adapters only (on the host), never through
divans_tpu_torch.decompress.  The C ABI has no selector for
chunk_nibbles, as upstream; the deferred case sets it on the Python side
of the same interpreter (a wrapper of capi_support.new_writer) and every
other field through the selectors."""
import glob
import io
import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from divans_tpu import io_adapters as jio
from divans_tpu.options import DivansOptions as JOptions

from divans_tpu_torch import io_adapters
from divans_tpu_torch.options import DivansOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = b"".join(open(f, "rb").read() for f in sorted(glob.glob(
    os.path.join(REPO, "divans_tpu", "**", "*.py"), recursive=True)))

# (name, option dict of tests/test_torch_capi_support.py, selectors set,
# the fields no selector carries)
CASES = [
    ("defaults", {"metablock_size": 4096}, [(3, 12)], {}),
    ("deferred", {"metablock_size": 4096, "chunk_nibbles": 256,
                  "use_context_map": 1}, [(3, 12), (7, 1)],
     {"chunk_nibbles": 256}),
    ("no_cmap", {"metablock_size": 8192, "use_context_map": 0,
                 "quality": 9}, [(3, 13), (7, 0), (1, 9)], {}),
]
# selectors that carry no field: accepted and ignored
IGNORED = [5, 6, 8, 12, 13, 14, 15, 18, 19]

SHIM_SCRIPT = r"""
import json, sys
import chip_smoke as cs
from divans_tpu_torch import capi_support
lib_path, payload_path = sys.argv[1], sys.argv[2]
cases = json.loads(sys.argv[3])
lib = cs.capi_lib(lib_path)
data = open(payload_path, "rb").read()
new_writer = capi_support.new_writer
report = {}
for name, selectors, extra, ignored in cases:
    # chunk_nibbles has no selector: set on the Python side
    capi_support.new_writer = lambda d: new_writer(dict(d, **extra))
    blob, res, codes = cs.capi_encode(lib, data, 3000, 100, selectors)
    blob_i, res_i, _c = cs.capi_encode(lib, data, 3000, 100,
                                       selectors + ignored)
    capi_support.new_writer = new_writer
    whole = cs.capi_decode(lib, blob, len(blob), 100)
    pieces = cs.capi_decode(lib, blob, 777, 100)
    report[name] = dict(
        blob=blob.hex(), same_with_ignored=blob_i == blob,
        set_option=sorted(set(res + res_i)), enc_codes=sorted(codes),
        whole=[whole[0] == data, whole[1], sorted(whole[3])],
        pieces=[pieces[0] == data, pieces[1], sorted(pieces[3])])
    if name == "defaults":
        for key, at in (("magic", 0), ("crc", len(blob) - 8)):
            bad = bytearray(blob)
            bad[at] = 0 if key == "magic" else bad[at] ^ 0xFF
            report[key] = list(cs.capi_decode(lib, bytes(bad), 777, 100)[1:3])
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def shim():
    """The shim and the example, built once with this interpreter (every
    test skips without the tools the build needs)."""
    missing = chip_smoke.capi_missing()
    if missing:
        pytest.skip(f"no {', '.join(missing)}")
    return chip_smoke.capi_build()


def _env():
    return dict(os.environ, DIVANS_TPU_PYTHONPATH=REPO,
                PATH=os.path.dirname(sys.executable) + os.pathsep
                + os.environ.get("PATH", ""))


def test_example_roundtrip(shim, tmp_path):
    """(a) ./example on 20,000 bytes of the repo's text prints ok."""
    payload = tmp_path / "payload"
    payload.write_bytes(TEXT[100000:120000])
    r = subprocess.run([os.path.join(shim, "example"), str(payload)],
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok 20000 -> "), r.stdout


@pytest.fixture(scope="module")
def driven(shim, tmp_path_factory):
    """(data, the report of the shim driven by ctypes) on 18,000 bytes
    of text."""
    data = TEXT[30000:48000]
    path = tmp_path_factory.mktemp("capi") / "payload"
    path.write_bytes(data)
    cases = [(name, sel, extra, [(s, 1) for s in IGNORED])
             for name, _d, sel, extra in CASES]
    r = subprocess.run([sys.executable, "-c", SHIM_SCRIPT,
                        os.path.join(shim, "libdivans_tpu_torch_capi.so"),
                        str(path), json.dumps(cases)],
                       cwd=REPO, env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    return data, json.loads(r.stdout.strip().splitlines()[-1])


def _written(writer_cls, opts, data: bytes) -> bytes:
    sink = io.BytesIO()
    w = writer_cls(sink, opts)
    for off in range(0, len(data), 3000):
        w.write(data[off:off + 3000])
    w.flush_final()
    return sink.getvalue()


@pytest.mark.parametrize("name,opt_dict", [(c[0], c[1]) for c in CASES],
                         ids=[c[0] for c in CASES])
def test_shim_container_and_decode(driven, name, opt_dict):
    """(b) The shim's container equals both packages' adapters' for the
    same options (ignored selectors change nothing), and divans_decode
    gives the payload back, fed whole and in 777-byte pieces; the encode
    and the piecewise decode each see NEEDS_MORE_OUTPUT and
    NEEDS_MORE_INPUT and end in SUCCESS (flush, EOF)."""
    data, report = driven
    got = report[name]
    blob = bytes.fromhex(got["blob"])
    assert blob == _written(io_adapters.CompressorWriter,
                            DivansOptions(**opt_dict), data)
    assert blob == _written(jio.CompressorWriter, JOptions(**opt_dict), data)
    assert got["same_with_ignored"] and got["set_option"] == [0]
    assert got["enc_codes"] == [0, 1, 2]
    assert got["whole"] == [True, 0, [0, 2]]
    assert got["pieces"] == [True, 0, [0, 1, 2]]


def test_shim_error_codes(driven):
    """(c) A zeroed magic byte fails with code 10 (BAD_MAGIC), a flipped
    stored CRC with 19 (CRC_MISMATCH)."""
    _data, report = driven
    assert report["magic"] == [3, 10]
    assert report["crc"] == [3, 19]
