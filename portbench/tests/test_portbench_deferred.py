"""The deferred-q10 configuration's cell and its yardstick on the CPU:
the cell through the harness's rehearsal, kernel 1's work formula
against chip_smoke's, the benchmark's model of the grouped pipeline's
schedule against the program's counters, the frozen golden deferred
decoder against the program's containers, and the new readers on
hand-built runs (a parent without the spans or counters reads
nothing)."""
import glob
import importlib.util
import os
import subprocess
import sys
import sysconfig

import numpy as np
import pytest

from portbench import run, work_k1
from portbench.reference import deferred as rd

import chip_smoke
import divans_tpu_torch as port
from divans_tpu_torch.codec import decode, lit_decode
from divans_tpu_torch.codec.layout import ModelLayout, PROFILES
from divans_tpu_torch.container import format as fmt

CELL = "deferred.read-48m"
CHUNK = 256
LAYOUT = ModelLayout(PROFILES["cm"], lo_bucketed=True)


def _sample(n: int, k: int) -> bytes:
    files = sorted(glob.glob(os.path.join(
        sysconfig.get_paths()["stdlib"], "*.py")))
    return b"".join(open(f, "rb").read() for f in files[k:k + 8])[:n]


@pytest.fixture(scope="module")
def container():
    """Six 4 KiB frames of the program's chunk-256 container."""
    data = _sample(6 * 4096 - 100, 3)
    blob = port.compress(data, port.DivansOptions(chunk_nibbles=CHUNK,
                                                  metablock_size=4096),
                         device="cpu")
    return data, blob, fmt.deserialize(blob)[2]


def test_cell_rehearsal_is_correct_and_traced():
    cell = run.load_cell(CELL)
    assert cell.config["options"]["chunk_nibbles"] == CHUNK
    assert {m["name"] for m in cell.end_to_end} == {"decode_MBps",
                                                    "setup_s"}
    got = run.rehearse(CELL, 2 ** 32 + 101, seconds=0.2, block_bytes=9000)
    assert got["correct"] and got["failed"] == 0, got
    got = run.rehearse(CELL, 2 ** 32 + 103, seconds=0.2, trace=True,
                       block_bytes=9000)
    assert got["correct"], got
    for name in ("structure_ms", "execute_ms", "k1_fill_pct"):
        assert got["metrics"][name]["value"] > 0, (name, got)
    assert got["metrics"]["k1_fill_pct"]["value"] <= 100
    # off the card the device trace has nothing to read
    assert "k1_roofline" not in got["metrics"]


def test_work_formula_equals_chip_smokes(container):
    _data, _blob, frames = container
    ready = [(i, decode.decode_structure(f, CHUNK, LAYOUT))
             for i, f in enumerate(frames)]
    streams, n_lits, lcmaps, spds, _spans = decode.lane_jobs(frames, ready)
    queues, n_steps, _p = decode.pack_lane_queues(streams, n_lits, lcmaps,
                                                  spds, CHUNK)
    q, perm, n_pass = decode.group_inputs(queues, CHUNK, LAYOUT, "cpu")
    s = CHUNK // 2
    _out, carry = lit_decode.decode_group(q, perm, n_pass, n_steps, s)
    want = chip_smoke._group_work(queues, carry, n_steps, s)
    lanes = queues.words.shape[0]
    carry_bytes = sum(int(v.numel()) * 4 for v in carry.values())
    assert carry_bytes == lanes * work_k1.CARRY_BYTES_PER_LANE
    words = int(((carry["cursor"].long() + 1) // 2).sum()) * 4
    assert work_k1.group_work(queues.n_lit, words, lanes, n_steps, s,
                              carry_bytes) == want
    # the benchmark's own count of the words (every stream read whole)
    # is the program's to the last word of each stream
    mine = sum(work_k1.stream_words_bytes(p) for p, n in zip(streams, n_lits)
               if n)
    assert abs(mine - words) <= 4 * len(streams)
    for name in ("DECODE_OPS_PER_NIBBLE", "ADJ_OPS_PER_NIBBLE",
                 "PREMIX_OPS_PER_ENTRY", "COMMIT_OPS_PER_ENTRY"):
        assert getattr(work_k1, name) == getattr(chip_smoke, name)
    assert (work_k1.LANES, work_k1.GROUP_CHUNKS) == (decode.LANES,
                                                     decode.GROUP_CHUNKS)


@pytest.mark.parametrize("group_chunks", [0, 1, 128])
def test_schedule_equals_the_programs_counters(container, group_chunks):
    """The groups, lane chunks and slots the benchmark counts from the
    container and the input equal the program's counters."""
    data, blob, frames = container
    decode.reset_stats()
    assert decode.decompress_frames(frames, CHUNK, LAYOUT, "cpu",
                                    group_chunks=group_chunks) == data
    s = CHUNK // 2
    offs = np.concatenate([[0], np.cumsum([f.raw_len for f in frames])])
    totals = [rd.lit_total(data[offs[i]:offs[i + 1]])
              for i in range(len(frames))]
    subs = [rd.sub_streams(f.lit, t) for f, t in zip(frames, totals)]
    needs = [-(-t // s) for t in totals]
    groups = work_k1.groups(needs, work_k1.LANES * group_chunks)
    chunks = [[-(-n // s) for i in g for _p, n in subs[i]] for g in groups]
    assert decode.STATS["groups"] == len(groups)
    assert decode.STATS["lane_chunks"] == sum(map(sum, chunks))
    assert decode.STATS["slot_chunks"] == sum(
        work_k1.LANES * work_k1.longest_lane(c) for c in chunks)


def test_roofline_reader_counts_the_container(container):
    """k1_roofline on a hand-built run: the least time of the window's
    reads over the kernel's device time; None off the card or without
    the kernel."""
    data, blob, _frames = container
    spec = importlib.util.spec_from_file_location(
        "k1_roofline_under_test",
        os.path.join(run.HERE, "metrics", "k1_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    read = mod.read
    least = mod.container_seconds(blob, data)
    assert 0 < least < 1e-3

    class Dev:
        def __init__(self, busy):
            self.busy = busy

        def seconds(self, pattern):
            return self.busy if "lit_decode_group_kernel" in pattern else 0

    r = run.Run(run.load_cell(CELL), 1, [data], [blob], None)
    r.calls = [run.Call(0, "read", 0, 0.0, 1.0, data, None),
               run.Call(0, "read", 0, 1.0, 2.0, data, None)]
    assert read(r) is None
    r.device = Dev(4 * least)
    assert read(r) == pytest.approx(50.0)
    r.device = Dev(0.0)
    assert read(r) is None


def test_span_and_counter_readers():
    r = run.Run(run.load_cell(CELL), 1, [b"x"], [b""], None)
    r.calls = [run.Call(0, "read", 0, 0.0, 1.0, b"x", None),
               run.Call(0, "read", 0, 1.0, 2.0, b"x", None)]
    r.spans = [("decode/structure", 0.1, 0.2, 0.1),
               ("decode/structure", 0.1, 0.3, 0.2),
               ("decode/execute", 0.4, 0.41, 0.01),
               ("decode/structure", 1.1, 1.2, 0.1),
               ("decode/execute", 1.4, 1.43, 0.03)]
    r.stats = {"decode.lane_chunks": 300, "decode.slot_chunks": 400,
               "decode.groups": 2}
    assert run.reader(run.HERE, "structure_ms")(r) == pytest.approx(200.0)
    assert run.reader(run.HERE, "execute_ms")(r) == pytest.approx(20.0)
    assert run.reader(run.HERE, "k1_fill_pct")(r) == pytest.approx(75.0)
    # the parent: no such spans, no such counters
    r.spans = [("decode/device_pipeline", 0.0, 0.5, 0.5)]
    r.stats = {"decode.device_frames": 192}
    for name in ("structure_ms", "execute_ms", "k1_fill_pct"):
        assert run.reader(run.HERE, name)(r) is None


def test_reference_decodes_the_programs_containers(container):
    data, blob, frames = container
    assert rd.container_chunk(blob) == CHUNK
    offs = np.concatenate([[0], np.cumsum([f.raw_len for f in frames])])
    for i, f in enumerate(frames):
        assert rd.decode_frame(f.cmd, f.lit, f.raw_len, CHUNK) == \
            data[offs[i]:offs[i + 1]]
    got = rd.check_frames(blob, data, data, seed=2 ** 31 + 9)
    assert len(got["frames"]) == 3
    assert got["bad_vs_input"] == got["bad_vs_program"] == 0
    # a frame that differs is counted
    bad = bytearray(data)
    for i in got["frames"]:
        bad[offs[i]] ^= 1
    got = rd.check_frames(blob, data, bytes(bad), seed=2 ** 31 + 9)
    assert got["bad_vs_input"] == 0 and got["bad_vs_program"] == 3


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.deferred as rd; "
            "import portbench.work_k1; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'divans_tpu_torch', 'divans_tpu', 'jax', 'jaxlib', 'torch'}); "
            "print(','.join(bad))")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == ""
