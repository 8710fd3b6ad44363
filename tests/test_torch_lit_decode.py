"""The literal-decode kernel module and the lane decode of the port against
the JAX package: the plain chunk decode against the Pallas kernel
(interpret mode) on one real mid-stream chunk, the plain group decode's
bytes and final carry against `_decode_lit_scan_q(interpret=True)`, the
whole lane decode against that scan and against the numpy oracle
`decode_literals_np`, and the lane packing.  All bit-exact (integer
codec: tolerance zero).  The CUDA kernel itself (one launch a group) is
held against the plain group decode on the card by chip_smoke.py (the
card's machine has no JAX, so these tests run here only)."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divans_tpu import native as jnative
from divans_tpu.codec import pallas_decode as jpd
from divans_tpu.codec.layout import ModelLayout as JLayout
from divans_tpu.codec.layout import PROFILES as JPROFILES
from divans_tpu.container import format as jfmt
from divans_tpu.options import DivansOptions as JOptions

from divans_tpu_torch.codec import decode, lit_decode, lit_model
from divans_tpu_torch.codec.deferred import SUB_LIT, lit_subs_split
from divans_tpu_torch.codec.layout import ModelLayout, PROFILES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT = ModelLayout(PROFILES["cm"], lo_bucketed=True)
JLAYOUT = JLayout(JPROFILES["cm"], lo_bucketed=True)


def _text(n: int, skip: int = 0) -> bytes:
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    return b"".join(open(f, "rb").read() for f in files)[skip:skip + n]


def _binary(n: int, seed: int) -> bytes:
    d = open(os.path.join(REPO, "divans_tpu", "data", "rfc7932_dict.bin"),
             "rb").read()
    rng = np.random.default_rng(seed)
    return (d[90000:90000 + n // 2]
            + rng.integers(0, 256, n - n // 2, dtype=np.uint8).tobytes())


def _streams(data: bytes, mb: int, chunk: int):
    """Every literal sub-stream of a container made by the JAX package's
    native compress: (streams, n_lits, lcmaps, speeds)."""
    blob = jnative.compress(data, JOptions(metablock_size=mb,
                                           chunk_nibbles=chunk))
    _w, _mb, frames, _crc, _fl = jfmt.deserialize(blob)
    out = ([], [], [], [])
    for f in frames:
        sc = jnative.decode_cmd_structure(f.cmd, f.raw_len, JLAYOUT, chunk)
        assert sc is not None and sc.supported
        for j, payload in enumerate(lit_subs_split(f.lit)):
            out[0].append(payload)
            out[1].append(max(0, min(SUB_LIT, sc.lit_total - j * SUB_LIT)))
            out[2].append(sc.lcmap)
            out[3].append(sc.speeds)
    return out


def _lane_bytes(out, placement, n_lits, chunk):
    s = chunk // 2
    arr = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    res = []
    for p, n in zip(placement, n_lits):
        if p is None:
            res.append(b"")
        else:
            lane, c_off = p
            res.append(arr[lane, c_off * s:c_off * s + n].tobytes())
    return res


def _oracle(streams, n_lits, lcmaps, speeds, chunk):
    return [jpd.decode_literals_np(s, n, lc, sp, chunk)
            for s, n, lc, sp in zip(streams, n_lits, lcmaps, speeds)]


# ------------------------------------------------------------ packing

@pytest.mark.parametrize("spread", [None, 3])
def test_pack_lane_queues_matches_reference(spread):
    streams, n_lits, lcmaps, speeds = _streams(
        _text(30000) + _binary(6000, 1), 1 << 12, 256)
    streams.insert(2, b"")      # an empty stream takes no lane slot
    n_lits.insert(2, 0)
    lcmaps.insert(2, lcmaps[0])
    speeds.insert(2, speeds[0])
    q, n_steps, placement = decode.pack_lane_queues(
        streams, n_lits, lcmaps, speeds, 256, spread=spread)
    j_arrays, j_steps, j_placement = jpd.pack_lane_queues(
        streams, n_lits, lcmaps, speeds, 256, spread=spread)
    ref = decode.from_tpu_lane_arrays(j_arrays)
    for name in ("words", "counts", "state0", "n_lit", "woff", "lcmap",
                 "spd", "luts"):
        assert np.array_equal(getattr(q, name), getattr(ref, name)), name
    assert placement == j_placement and placement[2] is None
    # the port runs exactly the longest queue; the reference pads its
    # step count to a quarter power of two (a compile-cache bound)
    loads = [sum(-(-n_lits[i] // 128) for i in range(len(streams))
                 if placement[i] is not None and placement[i][0] == lane)
             for lane in range(decode.LANES)]
    assert n_steps == max(loads) <= j_steps
    if spread:
        assert q.counts.max() >= 3


# ------------------------------------------- kernel contract, one chunk

def _capture_chunk(step: int, chunk: int):
    """The kernel's inputs at chunk `step` of a real lane decode (a model
    that has adapted for `step` chunks), and the plain version's
    outputs on them."""
    streams, n_lits, lcmaps, speeds = _streams(
        _text(7000, skip=20000) + _binary(3000, 2), 1 << 12, chunk)
    q, n_steps, _pl = decode.pack_lane_queues(streams, n_lits, lcmaps,
                                              speeds, chunk)
    assert n_steps > step
    got = []

    def spy(*args):
        res = lit_decode.lit_decode_chunk_plain(*args)
        got.append((args, res))
        return res

    tensors, perm, n_pass = decode.group_inputs(q, chunk, LAYOUT, "cpu")
    lit_decode.decode_group_plain(tensors, perm, n_pass, step + 1,
                                  chunk // 2, chunk_fn=spy)
    return got[step]


def test_plain_chunk_matches_pallas_kernel():
    """lit_decode_chunk_plain against the Pallas kernel in interpret
    mode, on identical inputs: bytes, ctx, state, p1, p2 and pulls."""
    chunk = 64
    s = chunk // 2
    (model, words, lcmap, luts, sc_in, _s), (b_out, c_out, sc_out) = \
        _capture_chunk(5, chunk)
    assert int((sc_in[3] > 0).sum()) >= 2
    # the TPU layout: planes [192*16, 128], word window from the even
    # word below each cursor, 6-bit packed tables, scalar rows
    n_wrows = s + 8
    w = words.numpy()
    cursor = sc_in[4].numpy()
    widx = np.clip((cursor >> 1)[:, None] + np.arange(n_wrows), 0,
                   w.shape[1] - 1)
    t_model = model.numpy().transpose(1, 2, 0).reshape(192 * 16, -1)
    t_words = np.take_along_axis(w, widx, axis=1).T
    t_lcmap = np.stack([jpd.pack6(r) for r in lcmap.numpy()], axis=1)
    t_luts = np.repeat(jpd.pack6(luts.numpy())[:, None], 128, axis=1)
    st = sc_in.numpy()
    t_sc = np.concatenate([st[:4], (st[4] & 1)[None],
                           np.zeros((3, st.shape[1]), np.int32)])
    call = jax.jit(jpd._chunk_call(s, n_wrows, True))
    r_bytes, r_ctx, r_sc = [np.asarray(a) for a in call(
        jnp.asarray(t_model), jnp.asarray(t_words), jnp.asarray(t_lcmap),
        jnp.asarray(t_luts), jnp.asarray(t_sc))]
    assert np.array_equal(b_out.numpy().T, r_bytes)
    assert np.array_equal(c_out.numpy().T, r_ctx)
    assert np.array_equal(sc_out.numpy(), r_sc[:4])


# ------------------------------------------------------ whole lane decode

def test_group_carry_matches_jax_scan():
    """decode_group on CPU tensors (its plain version): the bytes and the
    final carry (committed model, weights, pend, state, cursor, p1, p2,
    n_rem, queue position) against the reference's scan with
    return_carry=True (Pallas kernel in interpret mode, XLA commit), its
    [B, 16, R] layout transposed.  Deep queues (two lanes), so lanes
    switch streams and one runs past its last stream."""
    chunk = 64
    streams, n_lits, lcmaps, speeds = _streams(
        _text(7000, skip=60000) + _binary(3000, 3), 1 << 12, chunk)
    q, n_steps, _placement = decode.pack_lane_queues(
        streams, n_lits, lcmaps, speeds, chunk, spread=2)
    assert q.counts.max() >= 2
    j_arrays, _j_steps, _ = jpd.pack_lane_queues(
        streams, n_lits, lcmaps, speeds, chunk, spread=2)
    tensors, perm, n_pass = decode.group_inputs(q, chunk, LAYOUT, "cpu")
    out, carry = lit_decode.decode_group(tensors, perm, n_pass, n_steps,
                                         chunk // 2)
    j_perm, offs = jpd.kernel_perm(JLAYOUT)
    ref, j_carry = jpd._decode_lit_scan_q(
        *[jnp.asarray(a) for a in j_arrays], jnp.asarray(j_perm),
        lit_model.R_LIT, chunk, n_steps, offs, True,
        n_renorm=jpd._renorm_bound_q(j_arrays[6], chunk // 2),
        return_carry=True)
    (committed, weights, pend, state, cursor, p1, p2, n_rem, fidx,
     _lcmap, _spd) = [jax.tree_util.tree_map(np.asarray, c) for c in j_carry]
    assert np.array_equal(out.numpy(), np.asarray(ref).astype(np.uint8))
    want = {"state": state, "cursor": cursor, "p1": p1, "p2": p2,
            "n_rem": n_rem, "fidx": fidx,
            "committed": committed.transpose(0, 2, 1), "weights": weights,
            "add": pend["add"].transpose(0, 2, 1),
            "limsum": pend["limsum"], "cnt": pend["cnt"],
            "wadj": pend["wadj"]}
    assert set(carry) == set(want) == set(lit_decode.CARRY)
    for name, ref_val in want.items():
        assert carry[name].dtype == torch.int32, name
        assert np.array_equal(carry[name].numpy(), ref_val), name
    # the commit moved the models away from CDF_INIT and left a pend
    assert (carry["committed"].numpy() != committed[:1, :1, 0]).any()
    assert carry["cnt"].numpy().any() or (n_rem > 0).any()


def test_decode_lanes_on_cpu_is_the_plain_group():
    """decode_lanes on the CPU is one decode_group call, i.e. its plain
    version: equal bytes, and a spy chunk_fn of the plain version sees
    every chunk of the group."""
    chunk = 64
    streams, n_lits, lcmaps, speeds = _streams(_text(3000, skip=9000),
                                               1 << 12, chunk)
    q, n_steps, _placement = decode.pack_lane_queues(
        streams, n_lits, lcmaps, speeds, chunk, lanes=4)
    calls = []

    def spy(*args):
        calls.append(1)
        return lit_decode.lit_decode_chunk_plain(*args)

    out = decode.decode_lanes(q, n_steps, chunk, LAYOUT, "cpu")
    tensors, perm, n_pass = decode.group_inputs(q, chunk, LAYOUT, "cpu")
    plain, _carry = lit_decode.decode_group_plain(tensors, perm, n_pass,
                                                  n_steps, chunk // 2)
    spied, _carry = lit_decode.decode_group_plain(
        tensors, perm, n_pass, n_steps, chunk // 2, chunk_fn=spy)
    assert torch.equal(out, plain) and torch.equal(spied, plain)
    assert len(calls) == n_steps


def test_lane_decode_matches_jax_scan():
    """decode_lanes (plain kernel + torch commit) against the reference's
    scan (Pallas kernel in interpret mode + XLA commit), every step."""
    chunk = 64
    streams, n_lits, lcmaps, speeds = _streams(
        _text(5000, skip=60000) + _binary(2000, 3), 1 << 12, chunk)
    q, n_steps, placement = decode.pack_lane_queues(
        streams, n_lits, lcmaps, speeds, chunk, spread=2)
    j_arrays, j_steps, _ = jpd.pack_lane_queues(
        streams, n_lits, lcmaps, speeds, chunk, spread=2)
    out = decode.decode_lanes(q, n_steps, chunk, LAYOUT, "cpu").numpy()
    ref = np.asarray(jpd.issue_lane_queues(j_arrays, j_steps, chunk, JLAYOUT,
                                           interpret=True))
    assert np.array_equal(out, ref[:, :out.shape[1]])
    assert not ref[:, out.shape[1]:].any()
    assert _lane_bytes(out, placement, n_lits, chunk) == \
        _oracle(streams, n_lits, lcmaps, speeds, chunk)


@pytest.mark.parametrize("case", ["text", "binary", "queues", "empty"])
def test_lane_decode_matches_oracle(case):
    chunk = 256
    if case == "binary":
        data = _binary(9000, 4) + _text(3000)
    else:
        data = _text(26000, skip=5000)
    streams, n_lits, lcmaps, speeds = _streams(data, 1 << 12, chunk)
    if case == "empty":
        for k in (0, 3):       # streams of frames without literals
            streams.insert(k, b"")
            n_lits.insert(k, 0)
            lcmaps.insert(k, lcmaps[-1])
            speeds.insert(k, speeds[-1])
    spread = 3 if case == "queues" else None
    q, n_steps, placement = decode.pack_lane_queues(
        streams, n_lits, lcmaps, speeds, chunk, lanes=8, spread=spread)
    if case == "queues":
        assert q.counts.max() >= 3
    out = decode.decode_lanes(q, n_steps, chunk, LAYOUT, "cpu")
    assert _lane_bytes(out, placement, n_lits, chunk) == \
        _oracle(streams, n_lits, lcmaps, speeds, chunk)


def test_lane_decode_crosses_sub_streams():
    """A frame with more than SUB_LIT literals codes several sub-streams,
    each with a fresh model; each decodes on its own lane."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, SUB_LIT + 9000, dtype=np.uint8).tobytes()
    blob = jnative.compress(data, JOptions(metablock_size=1 << 16,
                                           chunk_nibbles=256))
    (frame,) = jfmt.deserialize(blob)[2]
    sc = jnative.decode_cmd_structure(frame.cmd, frame.raw_len, JLAYOUT, 256)
    streams = lit_subs_split(frame.lit)
    n_lits = [min(SUB_LIT, sc.lit_total - j * SUB_LIT)
              for j in range(len(streams))]
    assert len(streams) == 2 and n_lits[0] == SUB_LIT
    q, n_steps, placement = decode.pack_lane_queues(
        streams, n_lits, [sc.lcmap] * 2, [sc.speeds] * 2, 256, lanes=2)
    assert {p[0] for p in placement} == {0, 1}
    out = decode.decode_lanes(q, n_steps, 256, LAYOUT, "cpu")
    lits = b"".join(_lane_bytes(out, placement, n_lits, 256))
    assert jnative.execute_script(sc, lits) == data
