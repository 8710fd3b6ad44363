"""The readers of the program's tracelog spans: a traced rehearsal of
every cell (the CPU, the kernels' plain versions, a tiny size) reports
each of them, and a hand-built Run gives the expected sums per call."""
import json
import os

import pytest

from portbench import run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_traced_rehearsal_reads_every_span(name):
    cell = run.load_cell(name)
    got = run.rehearse(name, 2 ** 31 + 23, seconds=0.2, trace=True)
    assert got["correct"], got
    spans = [m["name"] for m in cell.per_layer
             if m["source"] == "program_span"]
    assert spans, cell.per_layer
    for m in spans:
        assert isinstance(got["metrics"][m]["value"], float), (m, got)


def test_span_readers_sum_per_call():
    """A span's time over the window over the op's completed calls,
    every event of it counted, on any thread; nothing where the program
    records no such span."""
    r = run.Run(run.load_cell("adaptive.write-4m"), 1, [b"x"], [], None)
    r.calls = [run.Call(0, "write", 0, 0.0, 1.0, b"", None),
               run.Call(0, "write", 0, 1.0, 2.0, b"", None),
               run.Call(0, "write", 0, 2.0, 3.0, None, "failed")]
    # (name, t0, t1, dt): two frames of the first call on two threads,
    # one of the second, and the failed call's
    r.spans = [("encode/parse", 0.1, 0.4, 0.3),
               ("encode/parse", 0.1, 0.3, 0.2),
               ("encode/trace_fsm", 0.4, 0.45, 0.05),
               ("encode/parse", 1.1, 1.2, 0.1),
               ("encode/trace_fsm", 1.2, 1.25, 0.05),
               ("encode/parse", 2.1, 2.2, 0.1)]
    assert run.reader(run.HERE, "trace_parse_ms")(r) == \
        pytest.approx(1e3 * 0.7 / 2)
    assert run.reader(run.HERE, "trace_fsm_ms")(r) == \
        pytest.approx(1e3 * 0.1 / 2)
    r.cell = run.load_cell("adaptive.read-4m")
    for c in r.calls:
        c.op = "read"
    r.spans = [("decode/pack", 0.0, 0.01, 0.01),
               ("decode/assemble", 0.5, 0.53, 0.03),
               ("decode/crc", 0.53, 0.54, 0.01),
               ("decode/pack", 1.0, 1.03, 0.03),
               ("decode/assemble", 1.5, 1.51, 0.01)]
    assert run.reader(run.HERE, "decode_pack_ms")(r) == pytest.approx(20.0)
    assert run.reader(run.HERE, "decode_assemble_ms")(r) == \
        pytest.approx(20.0)
    assert run.reader(run.HERE, "decode_crc_ms")(r) == pytest.approx(5.0)
    # a program without the span (the parent commit's), or no call
    r.spans = [("decode/device_pipeline", 0.0, 0.5, 0.5)]
    for name in ("decode_pack_ms", "decode_assemble_ms", "decode_crc_ms"):
        assert run.reader(run.HERE, name)(r) is None
    r.spans = [("decode/pack", 0.0, 0.01, 0.01)]
    r.calls = []
    assert run.reader(run.HERE, "decode_pack_ms")(r) is None
