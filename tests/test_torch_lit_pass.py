"""The encode's literal model pass of the port (codec/lit_pass.py)
against the JAX package: the native packer against pack_lit_row, the
port's lane layout against assemble_lit_planes, and lit_pass_plain (the
plain version of csrc/lit_pass.cu) against the XLA lit pass
jax_engine.model_pass_deferred_lit and, once, against the Pallas kernel
in interpret mode; a numpy model of the kernel's one-phase chunk loop
(its sparse commit into the other of two model copies, its
double-buffered weights) against both.  Every comparison is bit-exact
(integer codec: tolerance zero).  Inputs: the sorted divans_tpu
sources, a slice of the vendored dictionary, numpy-seeded bytes and
chip_smoke.lit_edge_lanes."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divans_tpu import native as jnative
from divans_tpu.codec import jax_engine
from divans_tpu.codec import pallas_lit_pass as plp
from divans_tpu.codec.layout import ModelLayout as JLayout, PROFILES as JP
from divans_tpu.options import DivansOptions as JOptions
from divans_tpu.probability.speed import Speed as JSpeed

import chip_smoke
from divans_tpu_torch import native
from divans_tpu_torch.codec import lit_pass
from divans_tpu_torch.codec.deferred import MAX_RENORM_PASSES
from divans_tpu_torch.probability import cdf16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JLAYOUT = JLayout(JP["cm"], lo_bucketed=True)
LIT_BASE = JLAYOUT.segments["lit_hi"][0]


def _data(n: int, seed: int = 0) -> bytes:
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    d = open(os.path.join(REPO, "divans_tpu", "data", "rfc7932_dict.bin"),
             "rb").read()
    rng = np.random.default_rng(seed)
    k = n // 8
    return (text[seed * 5000:seed * 5000 + n - 2 * k]
            + d[60000 + seed:60000 + seed + k]
            + rng.integers(0, 256, k, dtype=np.uint8).tobytes())


def _traces(n_blocks: int, mb_bits: int, chunk: int = 256, seed: int = 0,
            **kw):
    opts = JOptions(metablock_size=1 << mb_bits, chunk_nibbles=chunk, **kw)
    mb = opts.metablock_size
    data = _data(n_blocks * mb, seed)
    return [jnative.build_trace(data[o:o + mb], opts, JLAYOUT)
            for o in range(0, n_blocks * mb, mb)]


def _port_rows(traces):
    rows, spds = [], []
    for t in traces:
        r = native.pack_lit(t, LIT_BASE)
        assert r is not None
        rows.append(r[0])
        spds.append(r[1])
    return rows, spds


def _run_port(rows, spds, n_padded, chunk):
    packed, spd = lit_pass.assemble_lit_rows(rows, spds, n_padded)
    n_nib = np.array([2 * len(r) for r in rows], np.int32)
    st, fr = lit_pass.lit_pass(torch.from_numpy(packed),
                               torch.from_numpy(spd),
                               torch.from_numpy(n_nib), chunk)
    return st.numpy(), fr.numpy(), n_nib


def _compare_xla(lit_ts, rows, spds, chunk):
    """lit_pass_plain == model_pass_deferred_lit on every lane, up to the
    lane's nibble count (past it the port writes 0)."""
    n_padded = max(jax_engine._padded_len(
        max((t.shape[0] for t in lit_ts), default=1), chunk), chunk)
    spd_x = jax_engine.lit_speeds_from_traces(lit_ts)
    st_x, fr_x = jax_engine.model_pass_deferred_lit(
        jnp.asarray(jax_engine._pad_traces(lit_ts, multiple=chunk)),
        jnp.asarray(spd_x), 385, chunk)
    st_x, fr_x = np.asarray(st_x), np.asarray(fr_x)
    st, fr, n_nib = _run_port(rows, spds, n_padded, chunk)
    assert st.shape == st_x.shape
    for i, k in enumerate(n_nib):
        assert k == lit_ts[i].shape[0]
        if k:
            assert np.array_equal(spds[i], spd_x[i]), i
        assert np.array_equal(st[i, :k], st_x[i, :k]), i
        assert np.array_equal(fr[i, :k], fr_x[i, :k]), i
        assert not st[i, k:].any() and not fr[i, k:].any()


def _lit_ts(traces):
    return jax_engine.split_stream_traces(traces, JLAYOUT)[1]


# ------------------------------------------------------------- packing

@pytest.mark.parametrize("mixing", [1, 0])
def test_pack_lit_matches_reference(mixing):
    """native.pack_lit == the JAX package's native.pack_lit and its
    pallas_lit_pass.pack_lit_row on the rebased lit trace."""
    traces = _traces(3, 13, dynamic_context_mixing=mixing)
    for t, lt in zip(traces, _lit_ts(traces)):
        row, spd, cnt = native.pack_lit(t, LIT_BASE)
        j_row, j_spd, j_cnt = jnative.pack_lit(t, LIT_BASE)
        p_row, p_spd = plp.pack_lit_row(lt, 256)
        assert row.dtype == np.uint16 and cnt == j_cnt == lt.shape[0]
        assert np.array_equal(row, j_row) and np.array_equal(spd, j_spd)
        assert np.array_equal(row, p_row.astype(np.uint16))
        assert np.array_equal(spd, p_spd)


def test_pack_lit_outside_envelope_returns_none():
    t = _traces(1, 12)[0].copy()
    lit = np.nonzero(t[:, 2] == 1)[0]
    t[lit[1], 0] = LIT_BASE + 6    # a lo row pointing into the hi range
    assert native.pack_lit(t, LIT_BASE) is None
    assert jnative.pack_lit(t, LIT_BASE) is None


def test_from_tpu_lit_planes_matches_assemble():
    """The TPU kernel's planes, carried across, equal the port's layout
    (a batch of 11 lanes: two 8-lane groups, the last one padded)."""
    traces = _traces(4, 12)
    rows, spds = _port_rows(traces)
    rows = rows + [r[:100] for r in rows] + [rows[0][:0], rows[1], rows[2]]
    spds = spds + spds + [spds[0], spds[1], spds[2]]
    chunk = 64
    n_padded = -(-2 * max(len(r) for r in rows) // chunk) * chunk
    packed, spd = lit_pass.assemble_lit_rows(rows, spds, n_padded)
    j_packed, j_spd = plp.assemble_lit_planes(rows, spds, n_padded, chunk)
    c_packed, c_spd = lit_pass.from_tpu_lit_planes(j_packed, j_spd)
    b = len(rows)
    assert packed.dtype == np.uint16 and c_packed.shape == (16, n_padded // 2)
    assert np.array_equal(c_packed[:b], packed) and not c_packed[b:].any()
    assert np.array_equal(c_spd[:b], spd) and not c_spd[b:].any()


# ------------------------------------------------------ the model pass

@pytest.mark.parametrize("case", [
    dict(n_blocks=2, mb_bits=14),
    dict(n_blocks=2, mb_bits=14, dynamic_context_mixing=0),
    dict(n_blocks=2, mb_bits=13, literal_adaptation=(
        JSpeed(16, 8192), JSpeed(32, 4096), JSpeed(8, 8192),
        JSpeed(2, 1024))),
    dict(n_blocks=2, mb_bits=13, chunk=64),
], ids=["real", "no_mixing", "speeds", "chunk64"])
def test_plain_matches_xla_lit_pass(case):
    """Real traces, several chunks a lane (the lag, the renorm passes and
    the mixer's i16-wrapped norm weight all come into play)."""
    case = dict(case)
    chunk = case.pop("chunk", 256)
    traces = _traces(chunk=chunk, seed=1, **case)
    lit_ts = _lit_ts(traces)
    assert min(t.shape[0] for t in lit_ts) >= 4 * chunk
    _compare_xla(lit_ts, *_port_rows(traces), chunk)


def test_nonmultiple_batch_and_empty_lane():
    """Five lanes (not a multiple of the TPU's 8): three frames, an empty
    lane and a 512-row (256-byte) lane."""
    traces = _traces(3, 13, seed=2)
    lit_ts = _lit_ts(traces)
    rows, spds = _port_rows(traces)
    lit_ts = [lit_ts[0], lit_ts[0][:0], lit_ts[1], lit_ts[2],
              lit_ts[0][:512]]
    rows = [rows[0], rows[0][:0], rows[1], rows[2], rows[0][:256]]
    spds = [spds[0], spds[0], spds[1], spds[2], spds[0]]
    _compare_xla(lit_ts, rows, spds, 256)


def test_plain_matches_pallas_kernel():
    """One case against the Pallas kernel itself, in interpret mode."""
    traces = _traces(2, 13, seed=3)
    lit_ts = _lit_ts(traces)
    rows, spds = _port_rows(traces)
    n_padded = max(jax_engine._padded_len(
        max(t.shape[0] for t in lit_ts), 256), 256)
    st_p, fr_p = plp.model_pass_lit_pallas(lit_ts, 256, n_padded,
                                           interpret=True)
    st, fr, n_nib = _run_port(rows, spds, n_padded, 256)
    for i, k in enumerate(n_nib):
        assert np.array_equal(st[i, :k], np.asarray(st_p)[i, :k])
        assert np.array_equal(fr[i, :k], np.asarray(fr_p)[i, :k])


# ---- the kernel's one-phase commit, modelled in numpy ----------------------

INIT = 4 * np.arange(1, 17, dtype=np.int64)
WEIGHT_MAX = (1 << 30) - 1


def _i32(x):
    """int64 values wrapped to int32, kept as int64."""
    return (np.asarray(x, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)


def _wrap16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _weight_rule(w, adj):
    """One "which": (w0, w1, nw) after the summed adjustments (cm, nib):
    clip, the 24-bit over-rule, norm_weight with its i16 wraps.  Also
    whether the clip and the over-rule took effect."""
    raw = [int(_i32(w[i] + adj[i])) for i in (0, 1)]
    w0, w1 = (min(max(x, 1), WEIGHT_MAX) for x in raw)
    clipped = [w0, w1] != raw
    over_rule = bool((w0 | w1) & 0x7F000000)
    if over_rule:
        sh = max(w0.bit_length(), w1.bit_length()) - 24
        w0, w1 = w0 >> sh, w1 >> sh
    total = w0 + w1
    sh = max(total.bit_length() - 8, 0)
    inv = 1 + (1 << 24) // (total >> sh)
    num = (w0 >> sh) << 8
    q16 = _wrap16(((inv >> 12) * num + (((inv & 0xFFF) * num) >> 12)) >> 12)
    return [w0, w1, _wrap16(q16 << 7)], clipped, over_rule


def _one_phase_model(rows, spd, chunk):
    """csrc/lit_pass.cu's chunk loop, lane by lane, in numpy.  Model rows
    in the kernel's order: count row k (ctx for a hi nibble, 64 + idx for
    a lo one) feeds row 2k (speed 0) and 2k+1 (speed 3 for k < 64, else
    speed 2).  Chunk c is coded from one copy of the model and of the
    weights (the snapshot through c-2) while the snapshot through c-1 is
    written into the other: only the rows whose count row chunk c-1
    counted and the rows whose last commit left entry 15 at or above
    0x8000 (over) commit; a row committed into the other copy a chunk
    earlier and not now is copied across (the commit's path, no counts);
    every other row of that copy keeps what it held.  Returns
    ([(starts, freqs)] a lane, counts of the over-only commits, the
    copies, the weight clips and over-rules)."""
    s = chunk // 2
    m = np.arange(384)
    col = np.where(m % 2 == 0, 0, np.where(m < 128, 4, 2))
    stats = dict(over_only=0, copied=0, clipped=0, over_rule=0)
    out = []
    for row, sp in zip(rows, spd):
        p = row.astype(np.int64)
        inc, lim = sp[col].astype(np.int64), sp[col + 1].astype(np.int64)
        models = [np.tile(INIT, (384, 1)), np.tile(INIT, (384, 1))]
        weights = [[[1, 1, 1 << 14], [1, 1, 1 << 14]] for _ in range(2)]
        cnt = np.zeros((2, 192, 16), np.int64)
        counted = np.zeros((2, 192), bool)
        wadj = np.zeros((2, 2, 2), np.int64)
        over = np.zeros(384, bool)
        moved = np.zeros(384, bool)
        st_out = np.zeros(2 * len(p), np.int64)
        fr_out = np.zeros(2 * len(p), np.int64)
        for c in range(-(-len(p) // s)):
            par, pp = c & 1, (c & 1) ^ 1
            x = p[c * s:(c + 1) * s]
            ctx, hi, lo = x & 63, (x >> 6) & 15, (x >> 10) & 15
            act = ((x >> 14) & 1) != 0
            mix = torch.from_numpy(((x >> 15) & 1) != 0) & torch.from_numpy(
                act)
            snap = models[par]
            for which, k, sym, at in ((1, ctx, hi, 0),
                                      (0, 64 + (ctx >> 3) * 16 + hi, lo, 1)):
                nib, cm = (torch.from_numpy(np.where(
                    act[:, None], snap[2 * k + i], INIT).astype(np.int32))
                    for i in (0, 1))
                sym_t = torch.from_numpy(sym.astype(np.int32))
                coded = torch.where(mix[:, None], cdf16.average(
                    cm, nib, weights[par][which][2] & 0xFFFF), nib)
                start, freq = cdf16.sym_to_start_freq(coded, sym_t)
                adj = lit_pass.mixer_adjustments(
                    freq[None], cdf16.sym_to_start_freq(cm, sym_t)[1][None],
                    cdf16.sym_to_start_freq(nib, sym_t)[1][None], mix[None])
                wadj[par, which] = _i32(wadj[par, which] + adj[0].numpy())
                q = 2 * c * s + at + 2 * np.arange(len(x))
                st_out[q], fr_out[q] = start.numpy(), freq.numpy()
                np.add.at(cnt[par], (k[act], sym[act]), 1)
                counted[par, k[act]] = True
            # ---- the commit of chunk c-1's counts into the other copy
            todo = np.repeat(counted[pp], 2) | over
            carry = moved & ~todo
            stats["over_only"] += int((over & ~np.repeat(counted[pp], 2)
                                       ).sum())
            stats["copied"] += int(carry.sum())
            r = np.nonzero(todo | carry)[0]
            cum = np.cumsum(cnt[pp, r >> 1], axis=1)
            v = _i32(snap[r] + _i32(inc[r, None] * cum))
            lim_eff = np.where((inc[r] != 0) & (cum[:, 15] > 0), lim[r],
                               0x8000)
            for _ in range(MAX_RENORM_PASSES):
                hit = v[:, 15] >= lim_eff
                if not hit.any():
                    break
                cb = _i32(v + np.arange(1, 17))
                v = np.where(hit[:, None], cb - (cb >> 2), v)
            models[pp][r] = v
            over[r] = v[:, 15] >= 0x8000
            cnt[pp, counted[pp]] = 0
            counted[pp] = False
            moved = todo
            for which in (0, 1):
                weights[pp][which], clip, rule = _weight_rule(
                    weights[par][which], wadj[pp, which])
                stats["clipped"] += clip
                stats["over_rule"] += rule
            wadj[pp] = 0
        out.append((st_out, fr_out))
    return out, stats


def _lit_trace(row, sp):
    """A packed lane (ctx | hi<<6 | lo<<10 | act<<14 | mix<<15 a byte)
    and its speeds as the XLA pass's rebased [2n, 10] lit trace."""
    p = row.astype(np.int64)
    ctx, hi, lo = p & 63, (p >> 6) & 15, (p >> 10) & 15
    act, mix = (p >> 14) & 1, (p >> 15) & 1
    t = np.zeros((2 * len(p), 10), np.int64)
    t[0::2, 0], t[1::2, 0] = 1 + ctx, 65 + (ctx >> 3) * 16 + hi
    t[0::2, 1], t[1::2, 1] = hi, lo
    t[:, 2] = 1
    for h in (0, 1):
        t[h::2, 3], t[h::2, 4], t[h::2, 5] = act * sp[0], act * sp[1], mix
    t[0::2, 6] = 1
    t[0::2, 7], t[1::2, 7] = 193 + ctx, 257 + hi * 8 + (ctx >> 3)
    t[0::2, 8], t[0::2, 9] = sp[4], sp[5]
    t[1::2, 8], t[1::2, 9] = sp[2], sp[3]
    return t.astype(np.int32)


def _xla_and_plain(rows, spd, chunk):
    """(XLA starts, freqs, plain starts, freqs) of packed lanes, [B, N]."""
    lit_ts = [_lit_trace(r, sp) for r, sp in zip(rows, spd)]
    st_x, fr_x = jax_engine.model_pass_deferred_lit(
        jnp.asarray(jax_engine._pad_traces(lit_ts, multiple=chunk)),
        jnp.asarray(spd), 385, chunk)
    st_x, fr_x = np.asarray(st_x), np.asarray(fr_x)
    st, fr, _n = _run_port(rows, spd, st_x.shape[1], chunk)
    return st_x, fr_x, st, fr


def _check_lanes(rows, spd, chunk):
    """The one-phase model == the XLA pass == lit_pass_plain on every
    lane, up to its nibble count; returns the model's counts."""
    got, stats = _one_phase_model(rows, spd, chunk)
    st_x, fr_x, st, fr = _xla_and_plain(rows, spd, chunk)
    for i, (g_st, g_fr) in enumerate(got):
        k = g_st.shape[0]
        assert np.array_equal(g_st, st_x[i, :k]), i
        assert np.array_equal(g_fr, fr_x[i, :k]), i
        assert np.array_equal(st[i, :k], st_x[i, :k]), i
        assert np.array_equal(fr[i, :k], fr_x[i, :k]), i
    return stats


@pytest.mark.parametrize("chunk", [16, 256, 1024])
def test_one_phase_commit_matches_xla_and_plain(chunk):
    """The kernel's sparse, double-buffered commit, modelled in numpy,
    equals the XLA model_pass_deferred_lit and lit_pass_plain (the dense
    rule) on chip_smoke.lit_edge_lanes: rows taken in turns (a row is
    coded against only once two commits have brought it below 2^15, the
    XLA pass's exact row fetch) with commits that leave entry 15 at or
    above 0x8000 (lim 0xA000) and with rows at the 24-pass cap; a lane
    whose weights reach their clips and the 24-bit over-rule; inactive
    bytes, no mixing, a ragged last chunk and an empty lane.  The lanes
    are what the XLA trace builder packs (pallas_lit_pass.pack_lit_row)."""
    rows, spd = chip_smoke.lit_edge_lanes(chunk)
    for row, sp in zip(rows, spd):
        got = plp.pack_lit_row(_lit_trace(row, sp), chunk)
        assert np.array_equal(got[0], row)
        if len(row):
            assert np.array_equal(got[1], sp)
    stats = _check_lanes(rows, spd, chunk)
    assert stats["over_only"] >= 8, stats
    assert stats["copied"] >= 8, stats
    assert stats["clipped"] >= 1 and stats["over_rule"] >= 1, stats


@pytest.mark.parametrize("case", [
    dict(n_blocks=2, mb_bits=14),
    dict(n_blocks=2, mb_bits=13, chunk=64, dynamic_context_mixing=0),
], ids=["real", "no_mixing_chunk64"])
def test_one_phase_commit_matches_xla_on_real_traces(case):
    """The one-phase model on real traces (their speeds keep every row
    below 0x8000, so only counted rows commit, and copies carry them
    across)."""
    case = dict(case)
    chunk = case.pop("chunk", 256)
    traces = _traces(chunk=chunk, seed=4, **case)
    rows, spds = _port_rows(traces)
    stats = _check_lanes(rows, np.stack(spds).astype(np.int32), chunk)
    assert stats["over_only"] == 0 and stats["copied"] > 0, stats


@pytest.mark.parametrize("chunk", [16, 32, 64, 128, 256, 512, 1024])
def test_shared_memory_fits_a_block(chunk):
    """The kernel's dynamic shared memory (one size for every chunk the
    wrapper takes) fits a block (232,448 B) with room for its static
    words, and its threads at this chunk fit one (chip_smoke holds both
    against the kernel's own exports)."""
    assert lit_pass.SHARED_BYTES + 256 <= 232448
    assert lit_pass.threads(chunk) <= 1024
