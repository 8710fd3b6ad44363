"""The adaptive profile's decode scan of the port (codec/scan_decode)
against the JAX package's: pack_frames against jax_engine.pack_frames,
decode_scan_plain against jax_decode.decode_scan (the reference's XLA
while_loop) on containers of the reference's native.compress (cm,
quality 11 with dict commands, stride, mix), on test_jax_decode.py's edge
inputs (one byte, runs, bytes(range(140)), random bytes), on corrupt
streams and on lanes cut short by a small max_steps.  Window, ok and
wpos must be equal on every lane, corrupt ones included.  Each profile's
frames go through the reference in one batch, so it compiles once a
batch shape.  The kernel's two-warp design (csrc/scan_decode.cu: the cmd
warp's records, the literal warp's warp-wide rows) is emulated on the
host by tests/adaptive_lanes.py and held to the same outputs, exactly:
at each lane's end, cut at 1001 and 1004 micro-steps, cut inside a
literal run and inside a copy, on flipped bits, stride and mix lanes.
The adaptive decode's staging (codec/adaptive: the lanes sent up as they
are on the wire, expanded on the device) gives the scan pack_frames'
inputs exactly, on each batch and on lanes no encoder writes.

The two paths of the kernel that no command list reaches run on frames
written at the trace level (chip_smoke.scan_path_lanes): the escape drain
(a wrapped literal length sends the next copy's C_CS row into the
literal rows, so the cmd warp drains the ring first; the emulation counts
each drain) in the cm and mix profiles, and the mix model in the global
slab past its first micro-steps (mv_mode 0 frames that mix, then do
not).  On them decode_scan_plain equals the reference's scan and the
emulation equals both, exactly."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divans_tpu import native as jnative
from divans_tpu.codec import jax_decode, jax_engine
from divans_tpu.container import format as jfmt
from divans_tpu.ir import matcher as jmatcher
from divans_tpu.options import DivansOptions as JOptions

import adaptive_lanes
import chip_smoke
from divans_tpu_torch.codec import adaptive, scan_decode
from divans_tpu_torch.container import format as fmt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = 4096


def _text(n: int, seed: int) -> bytes:
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    start = int(np.random.default_rng(seed).integers(0, len(text) - n))
    return text[start:start + n]


def _frames(data: bytes, **kw):
    blob = jnative.compress(data, JOptions(metablock_size=MB, **kw))
    return [fmt.MetablockFrame(f.raw_len, f.cmd, f.lit)
            for f in jfmt.deserialize(blob)[2]]


def _flip(f, stream: str, seed: int):
    """The frame with one bit flipped past the state of its cmd or lit
    stream."""
    rng = np.random.default_rng(seed)
    b = bytearray(getattr(f, stream))
    b[int(rng.integers(4, len(b)))] ^= 1 << int(rng.integers(0, 8))
    return fmt.MetablockFrame(f.raw_len, *((bytes(b), f.lit)
                                           if stream == "cmd"
                                           else (f.cmd, bytes(b))))


def _both(frames, profile, max_steps=None, ref_steps=None):
    """(reference, port) outputs of the scan on these frames, each
    (window, ok, wpos) as numpy arrays; the reference at ref_steps
    micro-steps when given, else at the port's."""
    packed = scan_decode.pack_frames(frames)
    w, steps = packed[5:]
    steps = steps if max_steps is None else max_steps
    ref = jax_decode.decode_scan(*(jnp.asarray(a) for a in packed[:5]),
                                 profile, w, ref_steps or steps)
    got = scan_decode.decode_scan(*(torch.from_numpy(a)
                                    for a in packed[:5]), profile, w, steps)
    return ([np.asarray(a) for a in ref], [a.numpy() for a in got])


def _assert_equal(ref, got):
    for name, r, g in zip(("window", "ok", "wpos"), ref, got):
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.fixture(scope="module")
def dictionary_index():
    """The reference's dictionary index, built once single-threaded (its
    build is not guarded by a lock)."""
    jmatcher._dict_flat_index()


@pytest.fixture(scope="module")
def cm_paths():
    """chip_smoke.scan_path_lanes("cm"): the escape-drain lanes."""
    return chip_smoke.scan_path_lanes("cm")


@pytest.fixture(scope="module")
def cm_batch(dictionary_index, cm_paths):
    """(frames, data of each clean frame or None): multiblock text with a
    binary tail, quality 11 (dict commands), a mixing variant, the edge
    inputs, the escape-drain lanes, and two frames with a flipped bit in
    a cmd and a lit stream."""
    rng = np.random.default_rng(7)
    text = _text(2 * MB, seed=1) + rng.integers(
        0, 256, 600, dtype=np.uint8).tobytes()
    q11 = _text(MB, seed=2)
    pieces = [(text, {}), (q11, dict(quality=11)),
              (_text(1500, seed=3), dict(dynamic_context_mixing=2)),
              (b"A", {}), (b"@" * 5000, {}), (b"abcd" * 2000, {}),
              (bytes(range(140)), {}),
              (rng.integers(0, 256, 2048, dtype=np.uint8).tobytes(), {})]
    frames, raws = [], []
    for data, kw in pieces:
        got = _frames(data, **kw)
        frames += got
        raws += [data[o:o + MB] for o in range(0, len(data), MB)]
    assert len(raws) == len(frames)
    frames += [x["frame"] for x in cm_paths]
    raws += [x["data"] for x in cm_paths]
    frames += [_flip(frames[0], "cmd", 1), _flip(frames[1], "lit", 2)]
    raws += [None, None]
    return frames, raws


def test_pack_frames_matches_reference(cm_batch):
    frames, _raws = cm_batch
    ref = jax_engine.pack_frames(frames)
    got = scan_decode.pack_frames(frames)
    for r, g in zip(ref[:5], got[:5]):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert got[5:] == ref[5:]


def _edge_batch(cm_batch):
    """Two clean frames, then lanes no encoder writes: both empty,
    shorter than a state, a cmd lane cut short (corrupt), states at and
    past 2**31 (negative as int32)."""
    f = cm_batch[0][0]
    return cm_batch[0][:2] + [
        fmt.MetablockFrame(0, b"", b""),
        fmt.MetablockFrame(3, f.cmd[:1], f.lit[:3]),
        fmt.MetablockFrame(5, f.cmd[:2], b""),
        fmt.MetablockFrame(f.raw_len, f.cmd[:len(f.cmd) // 4 * 2], f.lit),
        fmt.MetablockFrame(9, b"\xff" * 4, b"\x00\x00\x00\x80\x01\x00")]


@pytest.mark.parametrize("batch", ["cm", "mix", "stride", "edge"])
def test_staged_lanes_equal_pack_frames(request, batch):
    """codec/adaptive's staging sends the lanes up as they are on the
    wire and expands them on the device (here the CPU): the scan's
    inputs equal pack_frames' element for element (states, both word
    arrays, raw_len) and its window_size and max_steps, on every batch
    this file builds, flipped, corrupt and empty lanes included."""
    frames = (_edge_batch(request.getfixturevalue("cm_batch"))
              if batch == "edge"
              else request.getfixturevalue(f"{batch}_batch")[0])
    want = scan_decode.pack_frames(frames)
    st = adaptive._Staging(torch.device("cpu"))
    p = st.pack(frames)
    got = st.upload(p)
    for name, g, w in zip(("cmd_states", "cmd_words", "lit_states",
                           "lit_words", "raw_len"), got, want[:5]):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (p.window_size, p.max_steps) == want[5:]


def test_staged_lanes_refuse_an_odd_lane(cm_batch):
    """A lane of odd length past its state has no whole u16 words: the
    staging raises ValueError where pack_frames does."""
    frames = cm_batch[0][:1] + [fmt.MetablockFrame(4, b"\x01" * 7, b"")]
    with pytest.raises(ValueError):
        scan_decode.pack_frames(frames)
    with pytest.raises(ValueError):
        adaptive._Staging(torch.device("cpu")).pack(frames)


@pytest.fixture(scope="module")
def cm_scan(cm_batch):
    """(reference, port) scans of cm_batch's frames at their own
    max_steps."""
    return _both(cm_batch[0], "cm")


def test_scan_matches_reference_cm(cm_batch, cm_scan):
    """Every lane equal to the reference's; the clean lanes other than
    quality 11's decode their data, quality 11's frames with dict
    commands are flagged (ok false) exactly where the reference flags
    them, and the corrupt lanes read what the reference reads."""
    frames, raws = cm_batch
    ref, got = cm_scan
    _assert_equal(ref, got)
    window, ok, _wpos = got
    for i, raw in enumerate(raws):
        if ok[i] and raw is not None:
            assert window[i, :len(raw)].tobytes() == raw
    n_text = 2 + 1    # the text's frames (its tail is one more frame)
    assert ok[:n_text].all() and ok[n_text + 1:-2].all()
    assert not ok[n_text]          # quality 11: its frame has dict commands
    assert not ok[-2]              # the cmd flip leaves the lane in error
    for i, raw in enumerate(raws[-4:-2], len(raws) - 4):   # the escapes
        assert ok[i] and window[i, :len(raw)].tobytes() == raw


@pytest.fixture(scope="module")
def stride_batch():
    """(frames, data): text with a binary tail in the stride profile,
    then the first frame with a flipped bit in its cmd stream."""
    rng = np.random.default_rng(8)
    data = _text(MB + 900, seed=4) + rng.integers(
        0, 256, 300, dtype=np.uint8).tobytes()
    frames = _frames(data, use_context_map=False, dynamic_context_mixing=0)
    frames.append(_flip(frames[0], "cmd", 3))
    return frames, data


def test_scan_matches_reference_stride(stride_batch):
    frames, data = stride_batch
    ref, got = _both(frames, "stride")
    _assert_equal(ref, got)
    assert got[1][:-1].all()
    assert b"".join(got[0][i, :f.raw_len].tobytes()
                    for i, f in enumerate(frames[:-1])) == data


@pytest.fixture(scope="module")
def mix_batch():
    """(frames, crafted lanes): the two frames compress writes for text
    with a binary tail in the mix profile, then
    chip_smoke.scan_path_lanes("mix") (escape drains, the slab lane)."""
    rng = np.random.default_rng(9)
    data = _text(MB, seed=5) + rng.integers(0, 256, 700,
                                            dtype=np.uint8).tobytes()
    paths = chip_smoke.scan_path_lanes("mix")
    return _frames(data, force_stride_value=4) + [x["frame"] for x in paths], \
        paths


@pytest.fixture(scope="module")
def mix_scan(mix_batch):
    """(reference, port) scans of mix_batch's frames."""
    return _both(mix_batch[0], "mix")


def test_scan_matches_reference_mix(mix_batch, mix_scan):
    """The mix profile (the model past the kernel's shared memory, in a
    global slab): the reference's scan flags the frames compress writes at
    the prediction mode's header (their mv_mode is 3, a constant mask,
    where the scan takes 0 only: jax_decode.py:603-606), before any byte,
    and the port's lanes stop there with it; the crafted mv_mode-0 lanes
    run to their end (the slab lane ~3,000 micro-steps, mixing and not)
    and decode their data, equal to the reference's."""
    frames, paths = mix_batch
    ref, got = mix_scan
    _assert_equal(ref, got)
    n = len(frames) - len(paths)
    assert n == 2 and not got[1][:n].any() and not got[2][:n].any()
    assert got[1][n:].all()
    for i, x in enumerate(paths, n):
        assert got[0][i, :len(x["data"])].tobytes() == x["data"]
    assert max(x["micro"] for x in paths) > 2000


@pytest.mark.parametrize("max_steps", [1001, 1004])
def test_scan_cut_by_max_steps(cm_batch, cm_scan, max_steps):
    """A small max_steps cuts every lane after max_steps micro-steps
    rounded up to a multiple of 4 (the reference tests its loop
    condition every 4 over all lanes, and a stopped lane's steps are
    no-ops): at 1001 and at 1004 the port's lanes equal the reference's
    at 1001, and each window up to the cut's wpos is the uncut scan's
    (window bytes below wpos are final)."""
    frames = cm_batch[0][:3]
    ref, got = _both(frames, "cm", max_steps=max_steps, ref_steps=1001)
    _assert_equal(ref, got)
    assert not got[1].any() and (got[2] > 0).all()
    full_window, _ok, full_wpos = cm_scan[1]
    for i, w in enumerate(got[2]):
        assert full_wpos[i] >= w
        assert (got[0][i, :w] == full_window[i, :w]).all()


def test_params_match_the_kernel_layout():
    """The kernel's parameter block: the segment offsets of the adaptive
    layout, the profile's dimensions, then both luts."""
    lay = scan_decode.layout_of("cm")
    p = scan_decode.params("cm")
    assert p.shape == (scan_decode.N_PARAMS + 2048,)
    assert p[0] == lay.segments["cc"][0]
    assert p[len(scan_decode.PARAM_SEGS)] == lay.num_rows == 2379
    assert scan_decode.layout_of("stride").num_rows == 4572


# ---------------------------------------- the kernel's two-warp design

def _lanes(frames, profile, max_steps=None):
    """tests/adaptive_lanes.py's emulation of csrc/scan_decode.cu (the cmd
    warp's records, cut where the lane stops; the literal warp's
    warp-wide rows) on these frames."""
    packed = scan_decode.pack_frames(frames)
    steps = packed[6] if max_steps is None else max_steps
    return adaptive_lanes.scan_lanes(*packed[:5], profile, packed[5], steps)


def _plain(frames, profile, max_steps):
    packed = scan_decode.pack_frames(frames)
    got = scan_decode.decode_scan_plain(
        *(torch.from_numpy(a) for a in packed[:5]), profile, packed[5],
        max_steps)
    return [a.numpy() for a in got]


def test_two_warp_scan_matches_reference(cm_batch, cm_scan):
    """The kernel's decomposition on cm_batch to each lane's end (text,
    quality 11 flagged at its dict command, a mixing variant, the edge
    inputs, a flipped bit in a cmd and a lit stream) equals the
    reference's scan exactly: window, ok, wpos."""
    _assert_equal(cm_scan[0], _lanes(cm_batch[0], "cm"))


@pytest.mark.parametrize("max_steps", [1001, 1004])
def test_two_warp_scan_cut_by_max_steps(cm_batch, max_steps):
    """The cut after (max_steps + 3) & ~3 micro-steps: each record the
    cmd warp pushes is cut to the bytes the serial FSM writes before it,
    so ok, wpos and the window equal the plain scan's."""
    frames = cm_batch[0][:3]
    _assert_equal(_plain(frames, "cm", max_steps),
                  _lanes(frames, "cm", max_steps))


def _cut_inside(frame, profile, kind: str, odd: bool):
    """A micro-step cut (a multiple of 4) inside a literal run or a copy
    of the frame: at an odd offset from a literal run's first micro-step
    (between a byte's two nibbles) or an even one (between bytes), or
    after a copy's first chunk and before its last."""
    packed = scan_decode.pack_frames([frame])
    recs = adaptive_lanes.cmd_records(packed[0], packed[1], packed[4],
                                      profile, 0, packed[6])
    for rec in recs:
        if rec[0] != kind or rec[-1] < 400:   # past the frame's first runs
            continue
        if kind == "lit":
            n, m0 = rec[1], rec[2]
            last = m0 + 2 * n
        else:
            n, dist, m0 = rec[1], rec[2], rec[3]
            last = m0 + -(-n // min(scan_decode.COPY_CHUNK, dist))
        for cut in range((m0 // 4 + 1) * 4, last, 4):
            if kind == "copy" or (cut - m0) % 2 == odd:
                return cut
    raise AssertionError(f"no {kind} run to cut in the frame")


@pytest.mark.parametrize("kind,odd", [("lit", True), ("lit", False),
                                      ("copy", False)],
                         ids=["lit-between-nibbles", "lit-between-bytes",
                              "copy"])
def test_two_warp_scan_cut_inside_a_run(cm_batch, kind, odd):
    """A cut that falls inside a literal run (between a byte's nibbles
    or between bytes) or inside a copy: the literal warp stops at exactly
    the micro-step the serial FSM would, the lane's wpos is the FSM's."""
    frame = cm_batch[0][0]
    cut = _cut_inside(frame, "cm", kind, odd)
    got = _lanes([frame], "cm", cut)
    _assert_equal(_plain([frame], "cm", cut), got)
    assert not got[1][0] and 0 < got[2][0] < frame.raw_len


def test_two_warp_scan_flipped_bits(cm_batch):
    """Frames with a flipped bit in the cmd or the lit stream (errors at
    raw_len, past it and mid-copy; lanes that read garbage to the end):
    every lane equal to the plain scan's."""
    frames = [_flip(cm_batch[0][i % 3], "cmd" if i % 2 else "lit", 10 + i)
              for i in range(6)]
    steps = scan_decode.pack_frames(frames)[6]
    _assert_equal(_plain(frames, "cm", steps), _lanes(frames, "cm"))


def test_two_warp_scan_stride_and_mix():
    """The stride profile's literal rows (the previous byte picks them)
    cut at 3001 micro-steps, and mix-profile lanes (the model in the
    global slab; flagged at the prediction mode's header)."""
    data = _text(MB, seed=6)
    stride = _frames(data, use_context_map=False, dynamic_context_mixing=0)
    _assert_equal(_plain(stride, "stride", 3001),
                  _lanes(stride, "stride", 3001))
    mix = _frames(data, force_stride_value=4)
    steps = scan_decode.pack_frames(mix)[6]
    got = _lanes(mix, "mix")
    _assert_equal(_plain(mix, "mix", steps), got)
    assert not got[1].any()



def _emulated(frames, idx, profile, scan):
    """The emulation of lanes idx of a batch, at the batch's window and
    max_steps, and its drains [len(idx), 2]; asserted equal to those
    lanes of the batch's (reference, port) scans."""
    w, steps = scan_decode.pack_frames(frames)[5:]
    packed = scan_decode.pack_frames([frames[i] for i in idx])
    drains = np.zeros((len(idx), 2), np.int64)
    got = adaptive_lanes.scan_lanes(*packed[:5], profile, w, steps,
                                    drains=drains)
    for side in scan:
        _assert_equal([a[idx] for a in side], got)
    return got, drains


def test_two_warp_scan_escape_drain(cm_batch, cm_scan, cm_paths):
    """The escape drain: on the crafted cm lanes the emulation drains the
    ring before each cmd row in the literal rows (as many times as the
    writer sent a C_CS row there; in the first lane once, at its first
    copy) and equals the plain scan and the reference, exactly."""
    frames = cm_batch[0]
    idx = list(range(len(frames) - 4, len(frames) - 2))
    _got, drains = _emulated(frames, idx, "cm", cm_scan)
    assert drains[:, 1].tolist() == [x["drains"] for x in cm_paths]
    assert (drains[:, 1] > 0).all()


def test_two_warp_scan_mix_paths(mix_batch, mix_scan):
    """The slab build's paths: on the crafted mix lanes (escape drains
    with the model in the global slab, the slab lane's thousands of
    micro-steps) the emulation equals the plain scan and the reference,
    and drains where the writer sent a cmd row into the literal rows."""
    frames, paths = mix_batch
    idx = list(range(len(frames) - len(paths), len(frames)))
    _got, drains = _emulated(frames, idx, "mix", mix_scan)
    assert drains[:, 1].tolist() == [x["drains"] for x in paths]
    assert drains[:2, 1].min() > 0 and drains[2, 1] == 0
