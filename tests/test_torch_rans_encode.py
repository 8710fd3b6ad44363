"""The encode's wide rANS coder of the port (ans/rans_encode.py) against
the JAX package: encode_lanes_plain (the plain version of
csrc/rans_encode.cu) against the Pallas kernel in interpret mode and
against the XLA scan coder ans/kernels.encode_lanes, and the port's
compaction and wire assembly against compact_global, assemble_global
and assemble_lane_bytes.  Bit-exact throughout (tolerance zero).
Streams: real (start, freq) pairs from the port's literal model pass and
numpy-seeded random ones, with counts 0, 1, 511, 512, 513 and 1500, and
freq 0 in the padding (the kernel's max(freq, 1)).  The kernel's
magic-number division is emulated in numpy and checked against floor
division."""
import glob
import os

import numpy as np
import pytest
import torch

from divans_tpu.ans import kernels as jk
from divans_tpu.ans import pallas_kernels as pk

from divans_tpu_torch import DivansOptions, native
from divans_tpu_torch.ans import rans_encode
from divans_tpu_torch.codec import encode, lit_pass
from divans_tpu_torch.codec.layout import ModelLayout, PROFILES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = [0, 1, 511, 512, 513, 1500]


def _random_lanes(seed: int):
    """Valid rans32 pairs (start >= 1, start + freq <= 2^15)."""
    rng = np.random.default_rng(seed)
    n = max(COUNTS)
    starts, freqs = [], []
    for c in COUNTS:
        st = rng.integers(1, 1 << 15, n).astype(np.int32)
        # skewed freqs: many small ones make the state renormalize often
        top = (1 << 15) - st + 1
        fr = np.minimum(rng.geometric(1 / 300, n), top - 1).astype(np.int32)
        fr = np.maximum(fr, 1)
        starts.append(st[:c])
        freqs.append(fr[:c])
    return starts, freqs, list(COUNTS)


def _real_lanes():
    """(start, freq) of three literal sub-streams from the port's model
    pass on the sorted divans_tpu sources."""
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=True)
    opts = DivansOptions(metablock_size=1 << 13, chunk_nibbles=256)
    rows, spds = [], []
    for i in range(3):
        t = native.build_trace(text[i << 13:(i + 1) << 13], opts, layout)
        r = native.pack_lit(t, layout.segments["lit_hi"][0])
        rows.append(r[0])
        spds.append(r[1])
    n_nib = np.array([2 * len(r) for r in rows], np.int32)
    n_padded = -(-int(n_nib.max()) // 256) * 256
    packed, spd = lit_pass.assemble_lit_rows(rows, spds, n_padded)
    st, fr = lit_pass.lit_pass(torch.from_numpy(packed),
                               torch.from_numpy(spd),
                               torch.from_numpy(n_nib), 256)
    return ([st[i, :k].numpy() for i, k in enumerate(n_nib)],
            [fr[i, :k].numpy() for i, k in enumerate(n_nib)],
            [int(k) for k in n_nib])


def _lanes(kind: str):
    return _random_lanes(7) if kind == "random" else _real_lanes()


def _pallas(starts, freqs, counts):
    """The Pallas kernel (interpret mode) on the TPU layout; its inputs
    and outputs carried across to the port's."""
    st, fr, cnt = pk.pack_lanes(starts, freqs, counts)
    # pack_lanes pads freq with 1; put 0 back past each count
    t = np.arange(st.shape[0])[:, None, None]
    fr = np.where(t < cnt[None], fr, 0).astype(np.int32)
    words, flags, states = pk.encode_lanes_pallas(st, fr, cnt,
                                                  interpret=True)
    return (rans_encode.from_tpu_ans_lanes(st, fr, cnt),
            (np.asarray(words), np.asarray(flags), np.asarray(states)))


@pytest.mark.parametrize("kind", ["random", "real"])
def test_plain_matches_pallas_kernel(kind):
    (st, fr, cnt), (j_words, j_flags, j_states) = _pallas(*_lanes(kind))
    words, flags, states = rans_encode.encode_lanes(
        torch.from_numpy(st), torch.from_numpy(fr), torch.from_numpy(cnt))
    c_words, c_flags, c_states = rans_encode.from_tpu_ans_lanes(
        j_words, j_flags, j_states)
    assert np.array_equal(flags.numpy(), c_flags)
    assert np.array_equal(states.numpy(), c_states)
    assert np.array_equal(words.numpy(), c_words)
    # the flagged words are the wire; check they are really there
    assert flags.numpy().sum() > 0


@pytest.mark.parametrize("kind", ["random", "real"])
def test_plain_matches_scan_coder(kind):
    """Against ans/kernels.encode_lanes (XLA scan, front-compacted words):
    the port's compaction gives the same words, counts and states."""
    starts, freqs, counts = _lanes(kind)
    n = max(counts)
    st = np.zeros((len(counts), n), np.int32)
    fr = np.zeros((len(counts), n), np.int32)
    for i, (s, f) in enumerate(zip(starts, freqs)):
        st[i, :len(s)] = s
        fr[i, :len(f)] = f
    cnt = np.array(counts, np.int32)
    j_words, j_nw, j_states = [np.asarray(a) for a in jk.encode_lanes(
        st, fr, cnt)]
    words, flags, states = rans_encode.encode_lanes(
        torch.from_numpy(st), torch.from_numpy(fr), torch.from_numpy(cnt))
    flat, header = rans_encode.compact_global(words, flags,
                                              torch.from_numpy(cnt), states)
    nw, states = header.numpy()
    assert np.array_equal(nw, j_nw) and np.array_equal(states, j_states)
    off = np.concatenate([[0], np.cumsum(nw)])
    flat = flat.numpy().view(np.uint16)
    for i in range(len(counts)):
        assert np.array_equal(flat[off[i]:off[i + 1]],
                              j_words[i, :nw[i]].astype(np.uint16))


@pytest.mark.parametrize("kind", ["random", "real"])
def test_compaction_and_assembly_match_reference(kind):
    (st, fr, cnt), (j_words, j_flags, j_states) = _pallas(*_lanes(kind))
    j_flat, j_header = pk.compact_global(j_words, j_flags,
                                         cnt.reshape(-1, 128),
                                         j_states)
    j_flat, j_header = np.asarray(j_flat), np.asarray(j_header)
    words, flags, states = rans_encode.encode_lanes(
        torch.from_numpy(st), torch.from_numpy(fr), torch.from_numpy(cnt))
    flat, header = rans_encode.compact_global(words, flags,
                                              torch.from_numpy(cnt), states)
    header = header.numpy()
    total = int(header[0].sum())
    assert np.array_equal(header, j_header.reshape(2, -1))
    assert np.array_equal(flat.numpy()[:total].view(np.uint16),
                          j_flat[:total])
    lane_counts = [int(c) for c in cnt]
    got = rans_encode.assemble_global(flat.numpy()[:total], header[0],
                                      header[1], lane_counts)
    assert got == pk.assemble_global(j_flat, j_header[0], j_header[1],
                                     lane_counts)
    assert got == pk.assemble_lane_bytes(j_words, j_flags, j_states,
                                         lane_counts)
    assert all((g == b"") == (c == 0) for g, c in zip(got, lane_counts))


def _magic_divide(x, d):
    """csrc/rans_encode.cu's division on the chain, in numpy (uint64):
    l = ceil(log2 d) and m = ceil(2^(31+l) / d), computed ahead of the
    chain; q = umulhi(2x, m) >> l.  Returns (q, m)."""
    lg = np.array([int(v - 1).bit_length() for v in d.reshape(-1)],
                  np.uint64).reshape(d.shape)
    m = ((np.uint64(1) << (np.uint64(31) + lg)) + d - np.uint64(1)) // d
    q = (((x << np.uint64(1)) * m) >> np.uint64(32)) >> lg
    return q, m


@pytest.mark.parametrize("divisors", ["every_freq", "up_to_2^31"])
def test_magic_division_is_floor_division(divisors):
    """The kernel's division trick equals floor division for every
    divisor it can see on valid streams (freq in [1, 2^15]) and a sample
    up to 2^31 - 1, over dividends that include the extremes of the
    state's range [0, 2^31) (0, 1, d - 1, d, d + 1, the largest multiple
    of d and its neighbours, 2^31 - 1) and random ones; the magic number
    fits 32 bits.  A negative state takes the kernel's exact signed
    division instead."""
    rng = np.random.default_rng(11)
    top = 2**31 - 1
    if divisors == "every_freq":
        d = np.arange(1, 2**15 + 1, dtype=np.uint64)
    else:
        d = np.concatenate([rng.integers(2**15, top, 4000),
                            [2**15 + 1, 2**16, 2**30, top - 1, top]]
                           ).astype(np.uint64)
    mult = (np.uint64(top) // d) * d
    cols = [np.zeros_like(d), np.ones_like(d), d - 1, d, d + 1,
            np.minimum(2 * d - 1, top), mult, mult - 1,
            np.minimum(mult + 1, top), np.full_like(d, top),
            np.full_like(d, top - 1), np.uint64(top) - d]
    cols += [rng.integers(0, top, d.shape[0], dtype=np.int64
                          ).astype(np.uint64) for _ in range(16)]
    x = np.stack(cols, axis=1)
    dd = np.ascontiguousarray(np.broadcast_to(d[:, None], x.shape))
    q, m = _magic_divide(x, dd)
    assert np.array_equal(q, x // dd)
    assert int(m.max()) < 2**32


def test_split_subs_cuts_sub_lit_lanes():
    row = np.arange(70000, dtype=np.uint16)
    subs = encode.split_subs(row)
    assert [len(s) for s in subs] == [32768, 32768, 70000 - 65536]
    assert np.array_equal(np.concatenate(subs), row)
    assert [len(s) for s in encode.split_subs(row[:0])] == [0]
