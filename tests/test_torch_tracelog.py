"""The port's stage tracing (divans_tpu_torch/tracelog.py) on the port's
spans: the three cases of tests/test_tracelog.py (disabled, a compress
and decompress on the CPU, the CLI's -timing)."""
import numpy as np
import pytest

import divans_tpu_torch as port
from divans_tpu_torch import cli, tracelog


def test_disabled_records_nothing():
    tracelog.enable(False)
    tracelog.clear()
    with tracelog.span("x"):
        pass
    assert tracelog.events() == []


# chunk: (input size, the spans a compress and decompress must record).
# The adaptive case is small: its plain scan decodes a nibble at a time
# on the CPU.
STAGES = {
    256: (4000, {"encode/host_cmd_wait", "encode/lit_dispatch",
                 "encode/lit_pull", "encode/assemble",
                 "decode/device_pipeline"}),
    0: (800, {"encode/trace_build", "encode/model_pass", "encode/ans_lanes",
              "encode/assemble", "decode/device_pipeline",
              "decode/serial_frames"})}


@pytest.mark.parametrize("chunk", sorted(STAGES))
def test_compress_records_stages(chunk):
    n, want = STAGES[chunk]
    tracelog.clear()
    tracelog.enable()
    try:
        data = bytes(np.random.default_rng(7).integers(65, 91, n,
                                                       dtype=np.uint8))
        opts = port.DivansOptions(chunk_nibbles=chunk)
        blob = port.compress(data, opts, device="cpu")
        assert port.decompress(blob, device="cpu") == data
    finally:
        tracelog.enable(False)
    names = {e.name for e in tracelog.events()}
    assert want <= names, want - names
    report = tracelog.report()
    assert "encode/assemble" in report and "TOTAL" in report


def test_native_spans():
    """The host-only encode and decode keep the reference's native
    spans."""
    from divans_tpu_torch import native
    tracelog.clear()
    tracelog.enable()
    try:
        data = b"the quick brown fox " * 300
        assert native.decompress(native.compress(data)) == data
    finally:
        tracelog.enable(False)
    names = {e.name for e in tracelog.events()}
    assert {"encode/native_serial", "decode/native_serial"} <= names


def test_cli_timing_flag(tmp_path, capsys):
    tracelog.clear()
    src = tmp_path / "in"
    src.write_bytes(b"the quick brown fox " * 500)
    out = tmp_path / "out"
    try:
        rc = cli.main(["-c", "-deferred", "-timing", str(src), str(out)],
                      device="cpu")
    finally:
        tracelog.enable(False)
        tracelog.clear()
    assert rc == 0
    err = capsys.readouterr().err
    assert "TOTAL" in err and "encode/lit_dispatch" in err
