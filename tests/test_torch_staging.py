"""The adaptive decode's host staging (codec/adaptive._Staging), on the
CPU, where the same code runs with unpinned buffers: the way down
against the row-by-row assembly it replaced, byte for byte, on windows
that mix ok and flagged frames, a short last frame and a frame of no
bytes; a thread's buffers growing once and then reused
(adaptive.STATS' staging_grows); a call after a larger one reading
nothing of it; and threads decoding at once, each through its own
buffers.  test_torch_scan_decode.py holds the way up against
scan_decode.pack_frames."""
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import divans_tpu_torch as port
from divans_tpu_torch import native
from divans_tpu_torch.codec import adaptive, scan_decode
from divans_tpu_torch.container import format as fmt

CPU = torch.device("cpu")


def _frames(raw_len, seed: int):
    """Frames of these lengths with seeded even-length lanes (the way
    down reads only raw_len)."""
    rng = np.random.default_rng(seed)
    return [fmt.MetablockFrame(int(n), rng.bytes(2 * int(rng.integers(2, 40))),
                               rng.bytes(2 * int(rng.integers(0, 40))))
            for n in raw_len]


def _old_assembly(window, ok, raw_len, host):
    """The assembly the staging replaced: each ok row's first raw_len
    bytes into one buffer, each flagged frame's host bytes in its place,
    then tobytes."""
    offsets = np.zeros(len(raw_len) + 1, np.int64)
    np.cumsum(raw_len, out=offsets[1:])
    width = int(max(raw_len))
    window = window[:, :width]
    out = np.empty(int(offsets[-1]), np.uint8)
    for i, n in enumerate(raw_len):
        if ok[i]:
            out[offsets[i]:offsets[i + 1]] = window[i, :n]
    for i, raw in host.items():
        out[offsets[i]:offsets[i + 1]] = np.frombuffer(raw, np.uint8)
    return out.tobytes()


def _down(st, raw_len, ok, seed: int):
    """(staged output, old assembly's output) of a seeded window."""
    rng = np.random.default_rng(seed)
    frames = _frames(raw_len, seed)
    p = st.pack(frames)
    window = rng.integers(0, 256, (len(raw_len), p.window_size),
                          dtype=np.uint8)
    host = {i: rng.bytes(int(n)) for i, n in enumerate(raw_len)
            if not ok[i]}
    got_ok = st.copy_back(torch.from_numpy(window),
                          torch.from_numpy(np.array(ok)), p)
    assert got_ok.tolist() == list(ok)
    return st.assemble(p, host), _old_assembly(window, ok, raw_len, host)


@pytest.mark.parametrize("raw_len,ok", [
    ([300, 300, 300, 41], [True, False, True, True]),
    ([256, 0, 256, 256, 7], [True, True, False, True, True]),
    ([64, 64, 0], [False, False, True]),
    ([0], [True]),
    ([513], [False]),
], ids=["short-last", "zero-length", "flagged-first", "one-empty",
        "all-flagged"])
def test_way_down_equals_the_row_assembly(raw_len, ok):
    st = adaptive._Staging(CPU)
    got, want = _down(st, raw_len, ok, seed=len(raw_len))
    assert got == want and len(got) == sum(raw_len)


def test_way_down_after_a_larger_call_reads_none_of_it():
    """The buffers keep a larger call's bytes past a smaller call's end;
    the smaller call's output stops at its own length."""
    st = adaptive._Staging(CPU)
    big, _ = _down(st, [900, 900, 900], [True, True, True], seed=1)
    got, want = _down(st, [100, 30], [True, False], seed=2)
    assert got == want and len(got) == 130
    assert st.down.numel() >= len(big) > len(got)


def _container(n: int, seed: int) -> tuple[bytes, bytes]:
    data = np.random.default_rng(seed).integers(
        97, 110, n, dtype=np.uint8).tobytes()
    return data, native.compress(data, port.DivansOptions())


def _in_new_thread(fn):
    with ThreadPoolExecutor(1) as pool:
        return pool.submit(fn).result(timeout=600)


def test_staging_grows_then_is_reused():
    """A new thread's first decode grows its buffers, a second of the
    same container and a smaller one reuse them and read none of the
    first's bytes, a larger one grows them again."""
    (small, small_blob), (big, big_blob) = _container(40, 3), \
        _container(90, 4)

    def run():
        adaptive.reset_stats()
        outs, grows = [], []
        for blob in (big_blob, big_blob, small_blob):
            outs.append(port.decompress(blob, device="cpu"))
            grows.append(adaptive.STATS["staging_grows"])
        st = adaptive.staging(CPU)
        sizes = st.up.numel(), st.down.numel()
        p = st.pack(_frames([4 * len(big)], seed=5))
        assert p.grew and st.down.numel() > sizes[1]
        return outs, grows, adaptive.STATS["staged_calls"]

    outs, grows, calls = _in_new_thread(run)
    assert outs == [big, big, small]
    assert grows == [1, 1, 1] and calls == 3


def test_threads_decode_through_their_own_buffers():
    """Two threads decoding different containers at once get their own
    bytes back; then more threads than cores, with a short switch
    interval, each staging its own frames up and down many times, read
    back only their own."""
    jobs = [_container(48, 6), _container(70, 7)]
    start = threading.Barrier(len(jobs))

    def decode(job):
        start.wait(timeout=60)
        return port.decompress(job[1], device="cpu"), \
            id(adaptive.staging(CPU))

    with ThreadPoolExecutor(len(jobs)) as pool:
        got = [f.result(timeout=600)
               for f in [pool.submit(decode, j) for j in jobs]]
    assert [out for out, _id in got] == [data for data, _b in jobs]
    assert got[0][1] != got[1][1]

    n = (os.cpu_count() or 1) + 1
    gate = threading.Barrier(n)

    def stage(k: int) -> int:
        rng = np.random.default_rng(100 + k)
        raw_len = rng.integers(0, 300, 1 + k % 4).tolist()
        frames = _frames(raw_len, seed=100 + k)
        want = scan_decode.pack_frames(frames)
        st = adaptive.staging(CPU)
        gate.wait(timeout=60)
        for it in range(30):
            p = st.pack(frames)
            for g, w in zip(st.upload(p), want[:5]):
                assert np.array_equal(g.numpy(), w)
            window = rng.integers(0, 256, (len(frames), p.window_size),
                                  dtype=np.uint8)
            ok = [True] * len(frames)
            st.copy_back(torch.from_numpy(window),
                         torch.ones(len(frames), dtype=torch.bool), p)
            assert st.assemble(p, {}) == _old_assembly(window, ok,
                                                       raw_len, {})
        return it + 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n) as pool:
            done = [f.result(timeout=600)
                    for f in [pool.submit(stage, k) for k in range(n)]]
    finally:
        sys.setswitchinterval(old)
    assert done == [30] * n
