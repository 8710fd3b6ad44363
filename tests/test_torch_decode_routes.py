"""The deferred decode's opt-in routes against the JAX package, on the
CPU (every kernel wrapper runs its plain version): the resumable lane
decoder segment by segment against the reference's (Pallas kernel in
interpret mode), kernel 1's contract resumed from a carry (its own, an
idle start, a reference carry over grown tables), the routes of
decompress_frames and their environment variables, and the last public
functions of pallas_decode (decode_structures, decode_literals_batch,
decode_literals_np).  Integer codec: every comparison is bit for bit.
The CUDA kernel resumed from a carry is held against the plain version
on the card by chip_smoke.py ([dec-routes])."""
import glob
import os

import jax
import numpy as np
import pytest
import torch

from divans_tpu import native as jnative
from divans_tpu.codec import pallas_decode as jpd
from divans_tpu.codec.layout import ModelLayout as JLayout
from divans_tpu.codec.layout import PROFILES as JPROFILES
from divans_tpu.container import format as jfmt
from divans_tpu.options import DivansOptions as JOptions

import divans_tpu_torch as port
from divans_tpu_torch import tracelog
from divans_tpu_torch.codec import decode, lit_decode
from divans_tpu_torch.codec.deferred import SUB_LIT, lit_subs_split
from divans_tpu_torch.codec.layout import ModelLayout, PROFILES
from divans_tpu_torch.container import format as fmt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT = ModelLayout(PROFILES["cm"], lo_bucketed=True)
JLAYOUT = JLayout(JPROFILES["cm"], lo_bucketed=True)
CHUNK = 64
S = CHUNK // 2


def _corpus(n: int, seed: int) -> bytes:
    """In-repo text (the sorted JAX-package sources),
    a slice of the vendored dictionary and seeded random bytes."""
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    text = text * (1 + n // len(text))
    d = open(os.path.join(REPO, "divans_tpu", "data", "rfc7932_dict.bin"),
             "rb").read()
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(text) - n))
    k = n // 25
    return (text[start:start + n - 2 * k] + d[50000 + seed:50000 + seed + k]
            + rng.integers(0, 256, k, dtype=np.uint8).tobytes())


def _container(n: int, seed: int, mb: int = 4096) -> tuple[bytes, bytes]:
    data = _corpus(n, seed)
    return data, jnative.compress(data, JOptions(metablock_size=mb,
                                                 chunk_nibbles=CHUNK))


def _streams(blob: bytes):
    """Every literal sub-stream of a container: [(payload, n_lit, lcmap,
    speeds)]."""
    out = []
    for f in jfmt.deserialize(blob)[2]:
        sc = jnative.decode_cmd_structure(f.cmd, f.raw_len, JLAYOUT, CHUNK)
        assert sc is not None and sc.supported
        for j, payload in enumerate(lit_subs_split(f.lit)):
            out.append((payload, max(0, min(SUB_LIT,
                                            sc.lit_total - j * SUB_LIT)),
                        sc.lcmap, sc.speeds))
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_carry_equal(got: dict, want: dict):
    assert set(got) == set(want) == set(lit_decode.CARRY)
    for k in lit_decode.CARRY:
        assert got[k].dtype == torch.int32, k
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------- the resumable lane decoder

BATCH_STEPS = (3, 2, 4)      # segments after each of the three batches
DRAIN_STEPS = 4


@pytest.fixture(scope="module")
def reference_run():
    """The reference's ResumableLaneDecoder (interpret mode) over 137
    streams of one container (so two lanes queue two), fed in three
    batches, a segment after each, then drained: each segment's keys
    added before it, steps, placements, bytes, the carry before and
    after it, and the queue tables it ran on."""
    _data, blob = _container(560000, seed=1)
    streams = _streams(blob)
    assert len(streams) > decode.LANES
    k = len(streams)
    batches = [streams[:k // 2], streams[k // 2:3 * k // 4],
               streams[3 * k // 4:]]
    dec = jpd.ResumableLaneDecoder(CHUNK, JLAYOUT, interpret=True)
    segs = []
    for i in range(len(BATCH_STEPS) + 64):
        batch = batches[i] if i < len(batches) else []
        if i >= len(batches) and dec.pending_chunks() == 0:
            break
        keys = [dec.add_stream(*st) for st in batch]
        steps = BATCH_STEPS[i] if i < len(BATCH_STEPS) else DRAIN_STEPS
        before = None if dec.carry is None else _np_tree(dec.carry)
        out, placements = dec.segment(steps)
        tables = dec._arrays()
        segs.append({"batch": batch, "keys": keys, "steps": steps,
                     "placements": placements,
                     "bytes": np.asarray(out).astype(np.uint8),
                     "before": before, "after": _np_tree(dec.carry),
                     "arrays": (np.asarray(dec.words_dev), *tables[:6],
                                np.asarray(dec.luts_dev))})
    assert max(len(r) for r in dec.rows) >= 2
    return segs


def test_resumable_decoder_matches_reference(reference_run):
    """Same streams, same batches, same segments: the port's keys,
    placements and bytes equal the reference's segment by segment, its
    final carry equals the reference's, and a stream that spans segments
    reassembles to decode_literals_np's bytes."""
    dec = decode.ResumableLaneDecoder(CHUNK, LAYOUT, "cpu")
    spans = {}
    for seg in reference_run:
        keys = [dec.add_stream(*st) for st in seg["batch"]]
        assert keys == seg["keys"]
        host, event, placements = dec.segment(seg["steps"])
        assert event is None
        assert placements == seg["placements"]
        assert np.array_equal(host.numpy(), seg["bytes"])
        for key, runs in placements.items():
            for ci, t, n in runs:
                lane = key[0]
                spans.setdefault(key, []).append(
                    (ci, host.numpy()[lane, t * S:(t + n) * S]))
    assert dec.pending_chunks() == 0 and dec.max_backlog() == 0
    _assert_carry_equal(dec.carry,
                        lit_decode.from_tpu_carry(reference_run[-1]["after"]))
    # the stream decoded over the most segments, against the oracle
    key, pieces = max(spans.items(), key=lambda kv: (len(kv[1]), kv[0]))
    assert len(pieces) >= 2
    stream = {k: st for seg in reference_run
              for st, k in zip(seg["batch"], seg["keys"])}[key]
    got = b"".join(p.tobytes() for _ci, p in sorted(pieces,
                                                     key=lambda x: x[0]))
    assert got[:stream[1]] == decode.decode_literals_np(*stream, CHUNK)


def test_port_resumes_from_reference_carry(reference_run):
    """decode_group started from the reference's carry after its first
    segment, on the tables the reference's second segment ran on (grown
    by a batch of streams): the reference's bytes and carry."""
    seg = reference_run[1]
    q = decode.from_tpu_lane_arrays(seg["arrays"])
    tensors, perm, n_pass = decode.group_inputs(q, CHUNK, LAYOUT, "cpu")
    out, carry = lit_decode.decode_group(
        tensors, perm, n_pass, seg["steps"], S,
        carry=lit_decode.from_tpu_carry(seg["before"]))
    assert np.array_equal(out.numpy(), seg["bytes"])
    _assert_carry_equal(carry, lit_decode.from_tpu_carry(seg["after"]))


# --------------------------------------------- kernel 1 from a carry

@pytest.fixture(scope="module")
def group():
    """A small group (deep queues on the first two of four lanes, the
    other two empty) and its decode from the preloaded start:
    (tensors, perm, n_pass, n_steps, bytes, final carry)."""
    _data, blob = _container(12000, seed=2)
    st = _streams(blob)
    q, n_steps, _placement = decode.pack_lane_queues(
        [s[0] for s in st], [s[1] for s in st], [s[2] for s in st],
        [s[3] for s in st], CHUNK, lanes=4, spread=2)
    assert q.counts.max() >= 2 and (q.counts == 0).any()
    tensors, perm, n_pass = decode.group_inputs(q, CHUNK, LAYOUT, "cpu")
    out, carry = lit_decode.decode_group(tensors, perm, n_pass, n_steps, S)
    return tensors, perm, n_pass, n_steps, out, carry


def test_idle_carry_equals_preloaded_start(group):
    tensors, perm, n_pass, n_steps, out, carry = group
    lanes = tensors["counts"].shape[0]
    idle = lit_decode.idle_carry(lanes, "cpu")
    assert idle["fidx"].eq(-1).all() and idle["n_rem"].eq(0).all()
    out_i, carry_i = lit_decode.decode_group(tensors, perm, n_pass, n_steps,
                                             S, carry=idle)
    assert torch.equal(out_i, out)
    # a lane with no stream stays idle (fidx -1) from the idle start
    empty = tensors["counts"] == 0
    assert carry_i["fidx"][empty].eq(-1).all()
    carry_i = dict(carry_i, fidx=torch.where(empty, 0, carry_i["fidx"]))
    _assert_carry_equal(carry_i, carry)


@pytest.mark.parametrize("cuts", [(5,), (1, 9), (3, 4, 11)],
                         ids=["one", "two", "three"])
def test_decode_group_resumed_over_cuts(group, cuts):
    """One call over the group against calls over its cuts, each from the
    last one's carry (the first from the preloaded start): equal bytes
    and final carry.  Streams span the cuts; lanes switch streams inside
    them."""
    tensors, perm, n_pass, n_steps, whole, carry_w = group
    bounds = [0, *cuts, n_steps]
    assert bounds == sorted(bounds)
    carry, parts = None, []
    for lo, hi in zip(bounds, bounds[1:]):
        out, carry = lit_decode.decode_group(tensors, perm, n_pass, hi - lo,
                                             S, carry=carry)
        parts.append(out)
    assert torch.equal(torch.cat(parts, dim=1), whole)
    _assert_carry_equal(carry, carry_w)
    # nothing decoded: the carry passes through
    out, same = lit_decode.decode_group(tensors, perm, n_pass, 0, S,
                                        carry=carry_w)
    assert out.shape == (tensors["counts"].shape[0], 0)
    _assert_carry_equal(same, carry_w)


# ---------------------------------------------- decompress_frames routes

@pytest.fixture(scope="module")
def small():
    """A three-frame container and its frames."""
    data, blob = _container(12000, seed=3)
    frames = fmt.deserialize(blob)[2]
    assert len(frames) == 3
    return data, blob, frames


def _spy_launches(monkeypatch):
    """Record (lanes, n_steps, resumed) of every decode_group call."""
    calls = []
    real = lit_decode.decode_group

    def spy(q, perm, n_pass, n_steps, s_bytes, carry=None):
        calls.append((q["words"].shape[0], n_steps, carry is not None))
        return real(q, perm, n_pass, n_steps, s_bytes, carry=carry)

    monkeypatch.setattr(lit_decode, "decode_group", spy)
    return calls


def _segments(fn):
    tracelog.clear()
    tracelog.enable()
    try:
        res = fn()
    finally:
        tracelog.enable(False)
    n = sum(ev.name == "decode/segment" for ev in tracelog.events())
    tracelog.clear()
    return res, n


@pytest.mark.parametrize("kw,lanes,stats", [
    (dict(resume=True, seg_steps=4), 128, (3, 0)),
    (dict(resume=True, qpl=2, seg_steps=5, seg_chunks=1), 256, (3, 0)),
    (dict(qpl=2), 256, (3, 0)),
    (dict(backlog=0), None, (0, 3)),
    (dict(backlog=1, group_chunks=0, workers=1), 128, None)],
    ids=["resume", "resume_qpl2", "qpl2", "backlog0", "backlog1"])
def test_routes_return_the_input(small, monkeypatch, kw, lanes, stats):
    data, _blob, frames = small
    calls = _spy_launches(monkeypatch)
    decode.reset_stats()
    raw, n_seg = _segments(lambda: decode.decompress_frames(
        frames, CHUNK, LAYOUT, "cpu", **kw))
    assert raw == data
    got = (decode.STATS["device_frames"], decode.STATS["host_frames"])
    assert decode.STATS["golden_frames"] == 0
    if stats is None:
        # backlog 1: a frame whose structure pass starts while a group is
        # in flight decodes on the host; the rest go to the card
        assert sum(got) == 3 and len(calls) == got[0]
    else:
        assert got == stats
    assert {c[0] for c in calls} <= {lanes}
    if kw.get("resume"):
        # one launch a segment, each from the last carry, seg_steps long
        assert n_seg == len(calls) >= 2
        assert all(c[2] and c[1] == kw["seg_steps"] for c in calls)
    else:
        assert n_seg == 0 and not any(c[2] for c in calls)


class _Pools:
    """ThreadPoolExecutor that records each pool's thread count."""
    sizes: list = []

    def __new__(cls, n):
        from concurrent.futures import ThreadPoolExecutor
        cls.sizes.append(n)
        return ThreadPoolExecutor(n)


@pytest.mark.parametrize("env,check", [
    ({"DIVANS_DEC_RESUME": "1", "DIVANS_DEC_SEG_STEPS": "6"},
     lambda calls, pools, st: all(c[2] and c[1] == 6 for c in calls)),
    ({"DIVANS_DEC_RESUME": "1", "DIVANS_DEC_SEG_STEPS": "3",
      "DIVANS_DEC_SEG_CHUNKS": "0"}, ValueError),
    ({"DIVANS_DEC_BACKLOG": "0"},
     lambda calls, pools, st: not calls and st["host_frames"] == 3),
    ({"DIVANS_DEC_QPL": "2"},
     lambda calls, pools, st: calls and all(c[0] == 256 for c in calls)),
    ({"DIVANS_DEC_GROUP_CHUNKS": "0"},
     lambda calls, pools, st: len(calls) == 3),
    ({"DIVANS_DEC_WORKERS": "3", "DIVANS_DEC_FINISHERS": "1"},
     lambda calls, pools, st: pools == [3, 1])],
    ids=["resume", "seg_chunks", "backlog", "qpl", "group_chunks",
         "pools"])
def test_environment_reaches_the_route(small, monkeypatch, env, check):
    """Each variable reaches its route through divans_tpu_torch.decompress
    (read at call time, as the reference reads them)."""
    data, blob, _frames = small
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = _spy_launches(monkeypatch)
    monkeypatch.setattr(decode, "ThreadPoolExecutor", _Pools)
    _Pools.sizes = []
    decode.reset_stats()
    if check is ValueError:
        with pytest.raises(ValueError):
            port.decompress(blob, device="cpu")
        return
    assert port.decompress(blob, device="cpu") == data
    assert check(calls, _Pools.sizes, decode.STATS)


def test_keyword_overrides_the_environment(small, monkeypatch):
    data, _blob, frames = small
    monkeypatch.setenv("DIVANS_DEC_RESUME", "1")
    monkeypatch.setenv("DIVANS_DEC_BACKLOG", "0")
    calls = _spy_launches(monkeypatch)
    decode.reset_stats()
    raw = decode.decompress_frames(frames, CHUNK, LAYOUT, "cpu",
                                   resume=False, backlog=999999)
    assert raw == data
    assert decode.STATS["device_frames"] == 3
    assert len(calls) == 1 and not calls[0][2]


# ------------------------------------- the last public functions

def test_decode_structures_match_reference(small):
    _data, blob, frames = small
    j_frames = jfmt.deserialize(blob)[2]
    got = decode.decode_structures(frames, CHUNK, LAYOUT)
    want = jpd.decode_structures(j_frames, CHUNK, JLAYOUT, JOptions())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g.ops, w.ops) and g.pool == w.pool
        assert (g.raw_len, g.lit_total, list(g.lcmap), g.supported) == \
            (w.raw_len, w.lit_total, list(w.lcmap), w.supported)
        assert [(s.inc, s.lim) for s in g.speeds] == \
            [(s.inc, s.lim) for s in w.speeds]
    # a frame outside the envelope (the mix profile's): None, as there
    mix = jfmt.deserialize(jnative.compress(_corpus(5000, seed=4), JOptions(
        chunk_nibbles=CHUNK, force_stride_value=4)))[2]
    assert jpd.decode_structures(mix, CHUNK, JLayout(
        JPROFILES["mix"], lo_bucketed=True), JOptions()) is None
    assert decode.decode_structures(mix, CHUNK, ModelLayout(
        PROFILES["mix"], lo_bucketed=True)) is None


def test_batch_and_numpy_oracle_match_reference(small):
    """decode_literals_batch (one stream a lane, plain version) and the
    port's decode_literals_np against the reference's
    decode_literals_np, with an empty stream among them."""
    _data, blob, _frames = small
    st = _streams(blob) + [(b"", 0, _streams(blob)[0][2],
                            _streams(blob)[0][3])]
    want = [jpd.decode_literals_np(p, n, lc, sp, CHUNK) for p, n, lc, sp
            in st]
    got = decode.decode_literals_batch(
        [s[0] for s in st], [s[1] for s in st], [s[2] for s in st],
        [s[3] for s in st], CHUNK, LAYOUT, "cpu")
    assert got == want and got[-1] == b""
    assert [decode.decode_literals_np(p, n, lc, sp, CHUNK)
            for p, n, lc, sp in st] == want
    with pytest.raises(ValueError):
        decode.decode_literals_batch([b""] * (decode.LANES + 1),
                                     [0] * (decode.LANES + 1), [], [], CHUNK,
                                     LAYOUT, "cpu")
