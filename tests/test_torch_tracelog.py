"""The port's stage tracing (divans_tpu_torch/tracelog.py) on the port's
spans: the three cases of tests/test_tracelog.py (disabled, a compress
and decompress on the CPU, the CLI's -timing), and the span record:
request ids, parents across the pool, self time, the profiler's
annotations."""
import json
import time

import numpy as np
import pytest
import torch

import divans_tpu_torch as port
from divans_tpu_torch import cli, tracelog


def test_disabled_records_nothing():
    tracelog.enable(False)
    tracelog.clear()
    with tracelog.span("x") as meta:
        assert meta is None
    assert tracelog.events() == []

    def fn():
        return 1
    assert tracelog.bound(fn) is fn


# chunk: (input size, the spans a compress and decompress must record).
# The adaptive case is small: its plain scan decodes a nibble at a time
# on the CPU.
STAGES = {
    256: (4000, {"encode/host_cmd_wait", "encode/lit_dispatch",
                 "encode/lit_pull", "encode/assemble",
                 "decode/device_pipeline", "api/compress", "api/decompress",
                 "encode/parse", "encode/trace_fsm", "decode/parse",
                 "decode/crc"}),
    0: (800, {"encode/trace_build", "encode/model_pass", "encode/ans_lanes",
              "encode/assemble", "decode/device_pipeline",
              "decode/serial_frames", "api/compress", "api/decompress",
              "encode/frame_trace", "encode/parse", "encode/trace_fsm",
              "encode/upload", "encode/lane_bytes", "decode/parse",
              "decode/pack", "decode/upload", "decode/scan",
              "decode/copy_back", "decode/assemble", "decode/crc"})}


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
    # one request a call, its pool workers' spans included
    roots = {e.id: e.name for e in tracelog.events() if e.parent is None}
    assert sorted(roots.values()) == ["api/compress", "api/decompress"]
    assert {e.request for e in tracelog.events()} == set(roots)


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


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A chunk-0 compress and decompress of 12 bytes, then a compress of
    nothing, under torch.profiler (CPU, every thread) with the tracelog
    on: (the spans, the chrome trace's user annotations).  The plain
    kernels' operations make the profiler slow, so the input is tiny."""
    data = b"ABRACADABRA!"
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    tracelog.clear()
    tracelog.enable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                experimental_config=cfg) as prof:
            blob = port.compress(data, device="cpu")
            assert port.decompress(blob, device="cpu") == data
            port.compress(b"", device="cpu")
    finally:
        tracelog.enable(False)
    evs = tracelog.events()
    tracelog.clear()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        ann = {e["name"] for e in json.load(f)["traceEvents"]
               if e.get("cat") == "user_annotation"}
    return evs, ann


def test_spans_of_a_call_share_its_request(traced):
    evs, _ann = traced
    by_id = {e.id: e for e in evs}
    roots = [e for e in evs if e.parent is None]
    assert [e.name for e in sorted(roots, key=lambda e: e.t0)] == \
        ["api/compress", "api/decompress", "api/compress"]
    # each call its own request, opened by its root
    assert len({e.request for e in evs}) == 3
    for e in evs:
        assert by_id[e.request].parent is None
        if e.parent is not None:
            assert by_id[e.parent].request == e.request
    assert len({e.id for e in evs}) == len(evs)
    # the container's serialisation is api.compress's, the lanes' bytes
    # the pipeline's
    parent = {e.name: by_id[e.parent].name for e in evs
              if e.parent is not None}
    assert parent["encode/assemble"] == "api/compress"
    assert parent["encode/lane_bytes"] == "api/compress"
    assert parent["decode/crc"] == parent["decode/parse"] == "api/decompress"
    for name in ("decode/pack", "decode/upload", "decode/scan",
                 "decode/copy_back"):
        assert parent[name] == "decode/device_pipeline"
    assert parent["encode/upload"] == "encode/model_pass"
    assert parent["encode/parse"] == parent["encode/trace_fsm"] == \
        "encode/frame_trace"


def test_pool_worker_spans_keep_their_parent(traced):
    evs, _ann = traced
    by_id = {e.id: e for e in evs}
    frames = [e for e in evs if e.name == "encode/frame_trace"]
    assert frames
    for e in frames:
        build = by_id[e.parent]
        assert build.name == "encode/trace_build"
        assert build.request == e.request
        assert e.thread != build.thread
        assert e.meta["steps"] > 0


def test_report_self_time(traced):
    """Self time on one thread sums to the root spans' total; a pool
    worker's spans add their own thread's time beside it."""
    evs, _ann = traced
    own = tracelog.self_seconds(evs)
    by_id = {e.id: e for e in evs}
    roots = sum(e.dt for e in evs if e.parent is None)
    pool = sum(e.dt for e in evs if e.parent is not None
               and by_id[e.parent].thread != e.thread)
    assert pool > 0
    assert sum(own.values()) == pytest.approx(roots + pool, abs=1e-9)
    assert all(v >= -1e-12 for v in own.values())

    # nested spans on one thread: the table's self column sums to TOTAL,
    # the root spans' time, and no span's time counts twice
    tracelog.clear()
    tracelog.enable()
    try:
        with tracelog.span("a"):
            with tracelog.span("b"):
                with tracelog.span("c"):
                    time.sleep(0.002)
                time.sleep(0.002)
            with tracelog.span("d"):
                time.sleep(0.002)
        with tracelog.span("e"):
            time.sleep(0.002)
        nested = tracelog.events()
        report = tracelog.report()
    finally:
        tracelog.enable(False)
        tracelog.clear()
    roots = sum(e.dt for e in nested if e.parent is None)
    assert sum(tracelog.self_seconds(nested).values()) == \
        pytest.approx(roots, abs=1e-9)
    rows = report.splitlines()
    assert "self ms" in rows[0]
    total = float(rows[-1].split()[0])
    assert rows[-1].split()[1] == "TOTAL"
    assert total == pytest.approx(roots * 1e3, abs=0.06)
    assert sum(float(r.split()[3]) for r in rows[1:-1]) == \
        pytest.approx(total, abs=0.06 * len(nested))
    assert total < 1e3 * sum(e.dt for e in nested)


def test_spans_are_profiler_annotations(traced):
    evs, ann = traced
    names = {e.name for e in evs}
    assert names <= ann, names - ann
