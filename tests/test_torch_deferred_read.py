"""The chunk-deferred read through divans_tpu_torch.decompress on the CPU
(the grouped pipeline: the native structure pass, kernel 1's plain
version a lane group, the native script execution): the bytes against
the input and, frame by frame, against the benchmark's frozen golden
decoder; the lane groups and the decode.STATS counters the same whatever
the order in which the structure pool's threads finish; the pipeline's
spans under their request; and the pools' sizes against the CPUs the
process may use."""
import glob
import os
import threading
import time

import numpy as np
import pytest

import divans_tpu_torch as port
from divans_tpu_torch import tracelog
from divans_tpu_torch.codec import decode
from divans_tpu_torch.codec.layout import ModelLayout, PROFILES
from divans_tpu_torch.container import format as fmt
from portbench.reference import deferred as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 256
MB = 8192
N_FRAMES = 14
LAYOUT = ModelLayout(PROFILES["cm"], lo_bucketed=True)
# one lane group's target at group_chunks 1 (128 lanes x 1 chunk) cuts
# the 14 frames (~17-28 chunks of literals each) into two groups
GROUP_CHUNKS = 1
SPANS = ("decode/structure", "decode/group_issue", "decode/group_finish",
         "decode/group_wait", "decode/lit_gather", "decode/execute")
COUNTERS = ("groups", "lane_chunks", "slot_chunks")


def _corpus(n: int, seed: int) -> bytes:
    """Seeded corpus-like bytes: a slice of the sorted JAX-package
    sources, a few random bytes at the end of each frame."""
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(text) - n))
    out = bytearray(text[start:start + n])
    for off in range(0, n, MB):
        k = min(off + MB, n) - 200
        out[k:k + 200] = rng.integers(0, 256, 200, np.uint8).tobytes()
    return bytes(out)


@pytest.fixture(scope="module")
def container():
    data = _corpus(N_FRAMES * MB, seed=2 ** 31 + 77)
    blob = port.compress(data, port.DivansOptions(chunk_nibbles=CHUNK,
                                                  metablock_size=MB),
                         device="cpu")
    frames = fmt.deserialize(blob)[2]
    assert len(frames) == N_FRAMES
    return data, blob, frames


def _run(frames, **kw):
    """One grouped decode: (bytes, each group's frame indices, the
    counters)."""
    got = []
    real = decode.lane_jobs

    def spy(frames_, ready):
        got.append([i for i, _sc in ready])
        return real(frames_, ready)

    decode.lane_jobs = spy
    try:
        decode.reset_stats()
        raw = decode.decompress_frames(frames, CHUNK, LAYOUT, "cpu",
                                       group_chunks=GROUP_CHUNKS, **kw)
    finally:
        decode.lane_jobs = real
    return raw, got, {k: decode.STATS[k] for k in COUNTERS}


def test_read_returns_the_input_and_the_references_frames(container):
    data, blob, frames = container
    decode.reset_stats()
    out = port.decompress(blob, device="cpu")
    assert out == data
    assert decode.STATS["device_frames"] == N_FRAMES
    assert decode.STATS["groups"] >= 1
    assert ref.container_chunk(blob) == CHUNK
    offs = np.concatenate([[0], np.cumsum([f.raw_len for f in frames])])
    for i, f in enumerate(frames):
        want = ref.decode_frame(f.cmd, f.lit, f.raw_len, CHUNK)
        assert want == out[offs[i]:offs[i + 1]], i
    got = ref.check_frames(blob, data, out, seed=2 ** 31 + 5)
    assert len(got["frames"]) == 3
    assert got["bad_vs_input"] == got["bad_vs_program"] == 0


def test_groups_do_not_depend_on_the_pool(container, monkeypatch):
    """The same groups, launches and counters at one worker, at eight,
    and with the structure passes finishing in reverse file order."""
    data, _blob, frames = container
    raw1, groups1, stats1 = _run(frames, workers=1)
    assert raw1 == data
    assert len(groups1) >= 2 and all(len(g) >= 2 for g in groups1)
    # consecutive frames in file order
    assert [i for g in groups1 for i in g] == list(range(N_FRAMES))
    raw8, groups8, stats8 = _run(frames, workers=8)
    assert (raw8, groups8, stats8) == (raw1, groups1, stats1)

    index = {id(f): i for i, f in enumerate(frames)}
    real = decode._structure
    done: list[int] = []
    lock = threading.Lock()

    def late_first(f, chunk, layout):
        time.sleep(0.03 * (N_FRAMES - index[id(f)]))
        with lock:
            done.append(index[id(f)])
        return real(f, chunk, layout)

    monkeypatch.setattr(decode, "_structure", late_first)
    rawr, groupsr, statsr = _run(frames, workers=8)
    # the passes did finish out of file order
    assert done != sorted(done)
    assert (rawr, groupsr, statsr) == (raw1, groups1, stats1)
    assert stats1["groups"] == len(groups1)
    assert 0 < stats1["lane_chunks"] <= stats1["slot_chunks"]
    assert stats1["slot_chunks"] % 128 == 0


def test_spans_share_the_request(container):
    """Every span of the grouped pipeline carries the request of its
    api/decompress root, those opened on the pools' threads too; each
    frame has its structure, gather and execute spans."""
    data, blob, frames = container
    tracelog.clear()
    tracelog.enable()
    try:
        decode.reset_stats()
        assert port.decompress(blob, device="cpu") == data
    finally:
        tracelog.enable(False)
    evs = tracelog.events()
    tracelog.clear()
    root = [e for e in evs if e.name == "api/decompress"]
    assert len(root) == 1 and root[0].parent is None
    mine = [e for e in evs if e.name in SPANS]
    assert {e.name for e in mine} == set(SPANS)
    assert all(e.request == root[0].id for e in mine)
    count = {n: sum(e.name == n for e in mine) for n in SPANS}
    assert count["decode/structure"] == count["decode/execute"] \
        == count["decode/lit_gather"] == N_FRAMES
    assert count["decode/group_issue"] == count["decode/group_finish"] \
        == count["decode/group_wait"] == decode.STATS["groups"]
    by_id = {e.id: e for e in evs}
    for e in mine:
        if e.name in ("decode/group_wait", "decode/lit_gather",
                      "decode/execute"):
            assert by_id[e.parent].name == "decode/group_finish"
        else:
            assert by_id[e.parent].name == "decode/device_pipeline"
    assert sum(e.meta["bytes"] for e in mine
               if e.name == "decode/structure") == len(data)
    issue = [e for e in mine if e.name == "decode/group_issue"]
    assert all(e.meta["lanes"] >= 1 and e.meta["chunks"] >= 1
               for e in issue)
    # the structure passes and the finishes ran on the pools' threads
    pool = {e.thread for e in mine if e.name in ("decode/structure",
                                                 "decode/group_finish")}
    assert root[0].thread not in pool


def test_tracing_off_records_nothing(container):
    data, blob, _frames = container
    tracelog.clear()
    tracelog.enable(False)
    assert port.decompress(blob, device="cpu") == data
    assert tracelog.events() == []


@pytest.mark.parametrize("n_cpus,want", [(1, 1), (2, 2), (4, 4), (8, 8),
                                         (16, 8), (64, 8)])
def test_pools_fit_the_cpus(n_cpus, want, monkeypatch):
    """A structure worker for each CPU the process may use, 1 to 8."""
    monkeypatch.setattr(decode.os, "sched_getaffinity",
                        lambda pid: set(range(n_cpus)))
    assert decode.structure_workers() == want


def test_default_pools_follow_the_affinity(container, monkeypatch):
    """With no keyword and no variable the structure pool has a thread a
    CPU of the process's affinity mask, and the finish pool two."""
    data, blob, _frames = container
    from concurrent.futures import ThreadPoolExecutor
    sizes = []

    def pools(n):
        sizes.append(n)
        return ThreadPoolExecutor(n)

    monkeypatch.delenv("DIVANS_DEC_WORKERS", raising=False)
    monkeypatch.delenv("DIVANS_DEC_FINISHERS", raising=False)
    monkeypatch.setattr(decode, "ThreadPoolExecutor", pools)
    monkeypatch.setattr(decode.os, "sched_getaffinity",
                        lambda pid: {0, 1, 2})
    monkeypatch.setattr(decode.os, "cpu_count", lambda: 64)
    assert port.decompress(blob, device="cpu") == data
    assert sizes == [3, 2]


def test_output_buffer_is_kept_across_calls(container):
    """A thread's output buffer is grown to its largest call and kept:
    a smaller call after a larger one reuses it, and each call's bytes
    are its own copy."""
    data, blob, _frames = container
    small = data[:2 * MB + 100]
    blob_s = port.compress(small, port.DivansOptions(chunk_nibbles=CHUNK,
                                                     metablock_size=MB),
                           device="cpu")
    first = port.decompress(blob, device="cpu")
    buf = decode._local.out
    assert buf.size >= len(data)
    assert port.decompress(blob_s, device="cpu") == small
    assert decode._local.out is buf
    assert first == data
    assert port.decompress(blob, device="cpu") == data
    assert decode._local.out is buf
