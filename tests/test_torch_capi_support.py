"""The port's C API helpers (divans_tpu_torch/capi_support.py) against
divans_tpu.capi_support: the writer's sink bytes for the same option
dict (C ints coerced the same way), and the push-style reader decoding
a container fed to it in pieces.  Host only, as the adapters are."""
import glob
import os

import pytest

from divans_tpu import capi_support as jcapi

from divans_tpu_torch import capi_support as capi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = b"".join(open(f, "rb").read() for f in sorted(glob.glob(
    os.path.join(REPO, "divans_tpu", "**", "*.py"), recursive=True)))


def _written(mod, opt_dict, data: bytes, piece: int) -> bytes:
    writer, sink = mod.new_writer(opt_dict)
    for off in range(0, len(data), piece):
        writer.write(data[off:off + piece])
    writer.flush_final()
    return sink.getvalue()


@pytest.mark.parametrize("opt_dict", [
    {"metablock_size": 4096},
    {"metablock_size": 4096, "chunk_nibbles": 256, "use_context_map": 1},
    {"metablock_size": 8192, "use_context_map": 0, "quality": 9}],
    ids=["defaults", "deferred", "no_cmap"])
def test_writer_matches_reference(opt_dict):
    data = TEXT[30000:48000]
    got = _written(capi, opt_dict, data, 5000)
    assert got == _written(jcapi, opt_dict, data, 5000)


def test_reader_decodes_pushed_pieces():
    data = TEXT[70000:90000]
    blob = _written(capi, {"metablock_size": 4096, "chunk_nibbles": 256},
                    data, 3000)
    src, reader = capi.new_reader()
    out = bytearray()
    for off in range(0, len(blob), 777):
        src.buf.extend(blob[off:off + 777])
        while True:
            piece = reader.read(1 << 16)
            if not piece:
                break
            out += piece
    assert bytes(out) == data
