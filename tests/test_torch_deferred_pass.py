"""The encode's generic deferred model pass of the port
(codec/deferred_pass.py) against the JAX package: deferred_pass_plain
(the plain version of csrc/deferred_pass.cu) against the normative
replay deferred.replay_trace, the XLA pass jax_engine.model_pass_deferred
and the Pallas kernel pallas_model.model_pass_deferred_pallas in
interpret mode, on real cm, stride and mix literal sub-traces and cmd
traces, and on seeded synthetic lanes (renorm-heavy, mixer weights at
their clamps, empty, of unequal lengths); the padding and the sub-trace
split against the reference's.  Every comparison is bit-exact (integer
codec: tolerance zero).  Inputs: the sorted divans_tpu sources, a
seeded sine wave (the strided profiles' home ground) and numpy-seeded
traces."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divans_tpu import native as jnative
from divans_tpu.codec import deferred as jdeferred
from divans_tpu.codec import jax_engine
from divans_tpu.codec import pallas_model
from divans_tpu.codec.layout import ModelLayout as JLayout, PROFILES as JP
from divans_tpu.options import DivansOptions as JOptions

from divans_tpu_torch.codec import deferred, deferred_pass, encode
from divans_tpu_torch.codec.deferred import cmd_chunk
from divans_tpu_torch.codec.lit_model import NORM_WEIGHT_INIT
from divans_tpu_torch.codec.lit_pass import mixer_adjustments
from divans_tpu_torch.probability import cdf16
from divans_tpu_torch.probability.weights import (WEIGHT_MAX, fix_weights,
                                                  norm_weight)
from divans_tpu_torch.codec.layout import (ModelLayout, PROFILES,
                                           profile_for_options)
from divans_tpu_torch.options import DivansOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 256
S_CMD = cmd_chunk(CHUNK)
PROFILE_OPTS = {"cm": {}, "stride": dict(use_context_map=False),
                "mix": dict(force_stride_value=4)}


def _data(n: int, seed: int) -> bytes:
    """Text (the sorted divans_tpu sources) then a seeded sine wave of
    period 4 (tests/test_mix_profile.py's signal) with noise."""
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    rng = np.random.default_rng(seed)
    k = n // 2
    t = np.arange(k)
    wave = (128 + 60 * np.sin(2 * np.pi * t / 4)
            + rng.integers(-3, 4, k)).astype(np.uint8).tobytes()
    return text[seed * 9000:seed * 9000 + n - k] + wave


def _streams(profile: str, n_blocks: int = 2, mb: int = 4096, seed: int = 1,
             data: bytes | None = None):
    """The reference's frame traces of a profile (of `data`, else of
    _data), split by stream: (cmd traces, lit traces rebased, r_cmd,
    r_lit)."""
    layout = JLayout(JP[profile], lo_bucketed=True)
    opts = JOptions(metablock_size=mb, chunk_nibbles=CHUNK,
                    **PROFILE_OPTS[profile])
    if data is None:
        data = _data(n_blocks * mb, seed)
    traces = [jnative.build_trace(data[o:o + mb], opts, layout)
              for o in range(0, n_blocks * mb, mb)]
    cmd_ts, lit_ts, _m, r_cmd, r_lit = jax_engine.split_stream_traces(
        traces, layout)
    return cmd_ts, lit_ts, r_cmd, r_lit


def _plain(ts, num_rows, s):
    """deferred_pass_plain on the lanes padded the port's way: (starts,
    freqs) numpy [B, N]; 0 past each lane is checked here."""
    trace, counts = encode.generic_inputs(ts, s)
    st, fr = deferred_pass.deferred_pass(torch.from_numpy(trace),
                                         torch.from_numpy(counts),
                                         num_rows, s)
    st, fr = st.numpy(), fr.numpy()
    for i, k in enumerate(counts):
        assert not st[i, k:].any() and not fr[i, k:].any()
    return st, fr


def _replay(t, s):
    """deferred.replay_trace of one lane on a clock of s steps."""
    if t.shape[0] == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    t = t.copy()
    t[:, 2] = 1   # the lit clock of replay_trace ticks every `s` steps
    return jdeferred.replay_trace(t, s)


def _compare(ts, num_rows, s, xla=True, pallas=False):
    """deferred_pass_plain == replay_trace on every lane (and the XLA
    pass and the Pallas kernel in interpret mode on the reference's own
    padding), up to each lane's count."""
    st, fr = _plain(ts, num_rows, s)
    refs = []
    if xla or pallas:
        padded = jax_engine._pad_traces(ts, multiple=s)
    if xla:
        sx, fx = jax_engine.model_pass_deferred(jnp.asarray(padded),
                                                num_rows, s)
        refs.append((np.asarray(sx), np.asarray(fx)))
    if pallas:
        assert len(ts) <= pallas_model.LANES
        sp, fp = pallas_model.model_pass_deferred_pallas(
            jnp.asarray(padded), num_rows, s, interpret=True)
        refs.append((np.asarray(sp), np.asarray(fp)))
    for i, t in enumerate(ts):
        k = t.shape[0]
        rs, rf = _replay(t, s)
        assert np.array_equal(st[i, :k], rs), i
        assert np.array_equal(fr[i, :k], rf), i
        for s_r, f_r in refs:
            assert np.array_equal(st[i, :k], s_r[i, :k]), i
            assert np.array_equal(fr[i, :k], f_r[i, :k]), i


@pytest.mark.parametrize("profile", ["cm", "stride", "mix"])
def test_real_lit_traces_match_replay_and_xla(profile):
    """Real literal sub-traces of each profile, tens of chunks a lane:
    the lag, the mixer, the touched rows' limits and the renorm passes
    all come into play."""
    _c, lit_ts, _rc, r_lit = _streams(profile)
    assert min(t.shape[0] for t in lit_ts) >= 10 * CHUNK
    assert all((t[:, 5] != 0).any() for t in lit_ts), "no mixing step"
    _compare(lit_ts, r_lit, CHUNK)


@pytest.mark.parametrize("profile", ["cm", "stride", "mix"])
def test_real_cmd_traces_match_replay_and_xla(profile):
    """Real cmd traces at cmd_chunk(256): the generic pass codes the
    cmd streams the cmd pass does not take."""
    cmd_ts, _l, r_cmd, _rl = _streams(profile, seed=2)
    _compare(cmd_ts, r_cmd, S_CMD)


@pytest.mark.parametrize("profile", ["stride", "mix"])
def test_real_traces_match_pallas_kernel(profile):
    """TPU kernel 5 itself (interpret mode), on <= 8 lanes: a frame's
    literal trace cut short, a whole small frame's and its cmd trace's
    head (each on its own clock), and an empty lane."""
    cmd_ts, lit_ts, r_cmd, r_lit = _streams(profile, n_blocks=1, seed=3)
    lanes = [lit_ts[0][:5 * CHUNK], lit_ts[0][:700],
             np.zeros((0, 10), np.int32)]
    _compare(lanes, r_lit, CHUNK, xla=False, pallas=True)
    _compare([cmd_ts[0][:6 * S_CMD]], r_cmd, S_CMD, xla=False, pallas=True)


def _synthetic(rng, n, num_rows, inc, lim, mix_share=0.5, cm_inc=8,
               cm_lim=8192):
    """A seeded lane of n steps over num_rows rows: random rows and
    symbols, a share of mixing steps on a cm row in the upper half."""
    t = np.zeros((n, 10), np.int32)
    t[:, 0] = rng.integers(0, num_rows // 2, n)
    t[:, 1] = rng.integers(0, 16, n)
    t[:, 2] = 1
    t[:, 3] = inc
    t[:, 4] = lim
    t[:, 5] = rng.random(n) < mix_share
    t[:, 6] = rng.integers(0, 2, n)
    t[:, 7] = rng.integers(num_rows // 2, num_rows, n)
    t[:, 8] = cm_inc
    t[:, 9] = cm_lim
    return t


def test_synthetic_lanes_of_unequal_length():
    """Seven lanes, 0 to 9 chunks and a ragged end, one of them empty."""
    rng = np.random.default_rng(5)
    ts = [_synthetic(rng, int(n), 40, 24, 0x2000)
          for n in (3 * 64 + 5, 0, 1, 9 * 64, 64, 2 * 64 - 1, 300)]
    _compare(ts, 40, 64)


@pytest.mark.parametrize("inc,lim", [(1024, 64), (16000, 2000)])
def test_renorm_heavy_lane(inc, lim):
    """Large inc, small lim, few rows: every commit renorms its rows
    several times (the touched-row rule of replay_trace)."""
    rng = np.random.default_rng(6)
    ts = [_synthetic(rng, 700, 6, inc, lim, cm_inc=inc, cm_lim=lim)
          for _ in range(3)]
    _compare(ts, 6, 32)


def test_renorm_cap_touched_rows_only():
    """inc far past the XLA pass's exact range (bf16 halves): row 1's
    commits hit the 24-pass cap and leave it above 0x8000; later steps
    code against it without touching it, and only touched rows renorm
    (deferred.replay_trace, the normative rule: the dense XLA pass would
    renorm row 1 again at every commit), so the oracle is the replay."""
    rng = np.random.default_rng(7)
    t = _synthetic(rng, 20 * 32, 4, 1 << 21, 64, mix_share=0.0)
    t[:5 * 32, 0] = 1                 # row 1 hit hard early
    later = t[5 * 32:]
    later[:, 0] = rng.integers(1, 4, later.shape[0])
    later[later[:, 0] == 1, 3] = 0    # then coded against, never touched
    _compare([t], 4, 32, xla=False)


def test_mixer_weights_reach_their_clamps(monkeypatch):
    """Every step mixes a cm row that learns one symbol fast with
    frozen, uniform nibble rows, in chunks of 1024: once the cm row is
    sharp, one chunk's adjustments push the cm weight past 2^24 (the
    rescale) and the nibble weight to its floor of 1."""
    summed = []
    apply = jdeferred.apply_weight_update

    def spy(w, a0, a1):
        summed.append((w[0] + a0, w[1] + a1))
        apply(w, a0, a1)

    monkeypatch.setattr(jdeferred, "apply_weight_update", spy)
    rng = np.random.default_rng(8)
    t = _synthetic(rng, 6 * 1024, 8, 0, 0x2000, mix_share=1.0, cm_inc=64,
                   cm_lim=0x7000)
    t[:, 1] = 3
    t[:, 6] = 1
    t[:, 7] = 5
    _compare([t], 8, 1024)
    assert max(w0 for w0, _w1 in summed) >= 1 << 24
    assert min(w1 for _w0, w1 in summed) < 1


def test_rows_out_of_range_raise():
    rng = np.random.default_rng(9)
    t = _synthetic(rng, 100, 10, 24, 0x2000)
    trace, counts = encode.generic_inputs([t], 32)
    for col, bad in ((0, 10), (7, -1), (1, 16), (6, 2)):
        tr = trace.copy()
        tr[0, 50, col] = bad
        with pytest.raises(ValueError, match="outside"):
            deferred_pass.deferred_pass(torch.from_numpy(tr),
                                        torch.from_numpy(counts), 10, 32)
    # past the lane's count a step is padding, never read
    tr = trace.copy()
    tr[0, 100:, 0] = 99
    st, _fr = deferred_pass.deferred_pass(torch.from_numpy(tr),
                                          torch.from_numpy(counts), 10, 32)
    assert st.shape == (1, 128)


@pytest.mark.parametrize("col,bad", [(0, 10), (7, -1), (1, 16), (6, 2)],
                         ids=["flat", "cm_idx", "value", "which"])
def test_host_check_rejects_what_the_card_check_rejects(col, bad):
    """check_lane (on the host, before the upload) raises on the same
    steps as check_trace, and a lane it passed still meets the plain
    version's check when the wrapper is told it was checked."""
    rng = np.random.default_rng(10)
    t = _synthetic(rng, 100, 10, 24, 0x2000)
    deferred_pass.check_lane(t, 10)
    trace, counts = encode.generic_inputs([t], 32)
    st, _fr = deferred_pass.deferred_pass(torch.from_numpy(trace),
                                          torch.from_numpy(counts), 10, 32,
                                          checked=True)
    assert st.shape == (1, 128)
    t[50, col] = bad
    with pytest.raises(ValueError, match="outside"):
        deferred_pass.check_lane(t, 10)


@pytest.mark.parametrize("kw", [dict(use_context_map=False),
                                dict(force_stride_value=4)],
                         ids=["stride", "mix"])
def test_host_frame_checks_generic_traces(monkeypatch, kw):
    """A frame whose literals take the generic pass has its rebased lit
    trace range-checked in the host pool (host_frame), so the card's
    launch needs no check of its own: a row past the lit sub-model
    raises there."""
    opts = DivansOptions(metablock_size=4096, chunk_nibbles=CHUNK, **kw)
    layout = ModelLayout(PROFILES[profile_for_options(opts)],
                         lo_bucketed=True)
    raw = _data(4096, 11)
    got = encode.host_frame(raw, opts, layout, CHUNK)
    assert got.lit_trace is not None and got.lit_row is None
    trace = encode.frame_trace(raw, opts, layout)
    trace[np.flatnonzero(trace[:, 2] == 1)[3], 0] = layout.num_rows
    monkeypatch.setattr(encode, "frame_trace", lambda *a: trace)
    with pytest.raises(ValueError, match="outside"):
        encode.host_frame(raw, opts, layout, CHUNK)


def test_padding_and_split_match_reference():
    """pad_traces equals jax_engine._pad_traces up to the port's length
    (the reference rounds to a quarter-power-of-two grid, the port to a
    whole chunk: the same padding rows); split_lit_sub_traces equals
    jax_engine._split_lit_sub_traces, here on lanes longer than one
    sub-stream."""
    rng = np.random.default_rng(4)
    data = _data(1 << 16, 4) + rng.integers(0, 256, 1 << 16,
                                            dtype=np.uint8).tobytes()
    _c, lit_ts, _rc, _rl = _streams("mix", n_blocks=2, mb=1 << 16,
                                    data=data)
    assert max(t.shape[0] for t in lit_ts) > 2 * jdeferred.SUB_LIT
    subs, spans = encode.split_lit_sub_traces(lit_ts + [lit_ts[0][:0]])
    j_subs, j_spans = jax_engine._split_lit_sub_traces(
        lit_ts + [lit_ts[0][:0]])
    assert spans == j_spans and len(subs) == len(j_subs)
    assert all(np.array_equal(a, b) for a, b in zip(subs, j_subs))
    ts = [subs[0][:1000], subs[1][:77], subs[0][:0]]
    got = deferred_pass.pad_traces(ts, CHUNK)
    ref = jax_engine._pad_traces(ts, multiple=CHUNK)
    assert got.shape == (3, 1024, 10) and got.dtype == np.int32
    assert np.array_equal(ref[:, :1024], got)
    assert (ref[:, 1024:] == got[2, 0]).all()


# ---- the kernel's on-chip pend, modelled in numpy --------------------------

def _i32(x):
    """int64 values wrapped to int32, kept as int64."""
    return (np.asarray(x, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)


def _kernel_pend_model(ts, num_rows, s):
    """csrc/deferred_pass.cu's pend, lane by lane, in numpy: a chunk's
    hits become records at their steps' places (2j the row, 2j+1 the cm
    row) keyed by the row's slot in an open-addressing hash of 4s slots
    (the kernel's multiplicative hash, linear probing), whose first
    insert appends the row to the chunk's touched list; the keys then
    trade slots for list places; the next chunk folds the records into
    a fold area of fold_rows(s) rows (the touched rows' 16 inc sums, lim
    sums and hits), in rounds when the list is longer, and commits the
    listed rows from it.  Each step is coded against the
    snapshot as the plain version codes it.  Returns ([(starts, freqs)]
    per lane, the rounds past the first, the longest touched list)."""
    k_rows = deferred_pass.fold_rows(s)
    hbits = (4 * s).bit_length() - 1
    bias = np.arange(1, 17)
    out, extra_rounds, longest = [], 0, 0
    for t in ts:
        n = t.shape[0]
        model = np.tile(4 * bias, (num_rows, 1)).astype(np.int64)
        weights = torch.tensor([[1, 1, NORM_WEIGHT_INIT]] * 2,
                               dtype=torch.int32)
        starts = np.zeros(n, np.int64)
        freqs = np.zeros(n, np.int64)
        prev = None
        for c in range(-(-n // s)):
            x = t[c * s:(c + 1) * s].astype(np.int64)
            q = torch.from_numpy(x.astype(np.int32))[None]
            flat, value, mix, which, cm_idx = (q[..., i]
                                               for i in (0, 1, 5, 6, 7))
            rows = torch.from_numpy(_i32(model[x[:, 0]]).astype(np.int32))[None]
            cm_rows = torch.from_numpy(
                _i32(model[x[:, 7]]).astype(np.int32))[None]
            do_mix = mix != 0
            nw = weights[which.long(), 2] & 0xFFFF
            coded = torch.where(do_mix[..., None],
                                cdf16.average(cm_rows, rows, nw), rows)
            start, freq = cdf16.sym_to_start_freq(coded, value)
            starts[c * s:c * s + x.shape[0]] = start[0].numpy()
            freqs[c * s:c * s + x.shape[0]] = freq[0].numpy()
            p_cm = cdf16.sym_to_start_freq(cm_rows, value)[1]
            p_nib = cdf16.sym_to_start_freq(rows, value)[1]
            wadj = torch.stack([mixer_adjustments(freq, p_cm, p_nib,
                                                  do_mix & (which == w))[0]
                                for w in (0, 1)])          # [which, 2]

            # ---- records, the row hash and the touched list
            hkey = np.full(4 * s, -1, np.int64)
            hval = np.zeros(4 * s, np.int64)
            touched = []
            key = np.full(2 * s, -1, np.int64)
            rinc = np.zeros(2 * s, np.int64)
            rlim = np.zeros(2 * s, np.int64)
            for j, st in enumerate(x):
                for at, row, inc, lim, on in (
                        (2 * j, st[0], st[3], st[4], st[3] != 0),
                        (2 * j + 1, st[7], st[8], st[9],
                         st[5] != 0 and st[8] != 0)):
                    if not on:
                        continue
                    slot = ((int(row) * 0x9E3779B1) & 0xFFFFFFFF) \
                        >> (32 - hbits)
                    while hkey[slot] not in (-1, row):
                        slot = (slot + 1) & (4 * s - 1)
                    if hkey[slot] == -1:
                        hkey[slot], hval[slot] = row, len(touched)
                        touched.append(row)
                    key[at] = slot | int(st[1]) << 16
                    rinc[at], rlim[at] = inc, lim
            live = key >= 0
            key[live] = (key[live] & ~0xFFFF) | hval[key[live] & 0xFFFF]
            longest = max(longest, len(touched))

            # ---- fold and commit the previous chunk's (lag 1)
            if prev is not None:
                pkey, pinc, plim, plist, pwadj = prev
                place, sym = pkey & 0xFFFF, pkey >> 16
                for r0 in range(0, len(plist), k_rows):
                    extra_rounds += r0 > 0
                    r1 = min(len(plist), r0 + k_rows)
                    sel = (pkey >= 0) & (place >= r0) & (place < r1)
                    f_add = np.zeros((r1 - r0, 16), np.int64)
                    f_lim = np.zeros(r1 - r0, np.int64)
                    f_hits = np.zeros(r1 - r0, np.int64)
                    np.add.at(f_add, (place[sel] - r0, sym[sel]), pinc[sel])
                    np.add.at(f_lim, place[sel] - r0, plim[sel])
                    np.add.at(f_hits, place[sel] - r0, 1)
                    v = _i32(model[plist[r0:r1]]
                             + _i32(np.cumsum(f_add, axis=1)))
                    lim_eff = _i32(f_lim) // np.maximum(f_hits, 1)
                    for _ in range(deferred.MAX_RENORM_PASSES):
                        over = v[:, 15] >= lim_eff
                        if not over.any():
                            break
                        cb = _i32(v + bias)
                        v = np.where(over[:, None], cb - (cb >> 2), v)
                    model[plist[r0:r1]] = v
                w01 = torch.clamp(weights[:, :2] + pwadj, 1, WEIGHT_MAX)
                w0, w1 = fix_weights(w01[:, 0], w01[:, 1])
                weights = torch.stack([w0, w1, norm_weight(w0, w1)], dim=-1)
            prev = (key, rinc, rlim, np.array(touched, np.int64), wadj)
        out.append((starts, freqs))
    return out, extra_rounds, longest


def _pend_lanes(s, seed):
    """Lanes at chunk s over 4s + 8 rows: every step mixing on rows
    distinct within its chunk (2s touched rows a chunk), and one row and
    one cm row hit by every step; moderate speeds, so the XLA pass's
    exact range holds."""
    rng = np.random.default_rng(seed)
    r = 4 * s + 8
    distinct = _synthetic(rng, 3 * s, r, 24, 0x2000, mix_share=1.0,
                          cm_inc=16, cm_lim=0x3000)
    for c in range(3):
        distinct[c * s:(c + 1) * s, 0] = rng.permutation(2 * s)[:s]
        distinct[c * s:(c + 1) * s, 7] = 2 * s + rng.permutation(2 * s)[:s]
    hot = _synthetic(rng, 3 * s + s // 2, r, 24, 0x2000, mix_share=1.0,
                     cm_inc=16, cm_lim=0x3000)
    hot[:, 0], hot[:, 7] = 3, 4 * s + 5
    return [distinct, hot], r


@pytest.mark.parametrize("s", [16, 1024])
def test_kernel_pend_matches_replay_and_xla(s):
    """The kernel's on-chip pend (records, row hash, fold in rounds,
    commit of the touched rows), modelled in numpy, equals
    deferred.replay_trace and the XLA model_pass_deferred on lanes whose
    chunks touch 2s distinct rows (at s = 1024 more than the fold area
    holds, so the commit runs in rounds) and on a row hit by every
    step."""
    ts, r = _pend_lanes(s, seed=20 + s)
    got, extra_rounds, longest = _kernel_pend_model(ts, r, s)
    assert longest == 2 * s
    assert (extra_rounds > 0) == (2 * s > deferred_pass.fold_rows(s))
    padded = jax_engine._pad_traces(ts, multiple=s)
    sx, fx = (np.asarray(a) for a in jax_engine.model_pass_deferred(
        jnp.asarray(padded), r, s))
    for i, t in enumerate(ts):
        k = t.shape[0]
        rs, rf = _replay(t, s)
        assert np.array_equal(got[i][0], rs), i
        assert np.array_equal(got[i][1], rf), i
        assert np.array_equal(sx[i, :k], rs), i
        assert np.array_equal(fx[i, :k], rf), i


def test_kernel_pend_renorm_cap_touched_rows_only():
    """The pend model at the 24-pass cap: touched rows only renorm, as
    in deferred.replay_trace (the case of
    test_renorm_cap_touched_rows_only)."""
    rng = np.random.default_rng(7)
    t = _synthetic(rng, 20 * 32, 4, 1 << 21, 64, mix_share=0.0)
    t[:5 * 32, 0] = 1
    later = t[5 * 32:]
    later[:, 0] = rng.integers(1, 4, later.shape[0])
    later[later[:, 0] == 1, 3] = 0
    (st, fr), = _kernel_pend_model([t], 4, 32)[0]
    rs, rf = _replay(t, 32)
    assert np.array_equal(st, rs) and np.array_equal(fr, rf)


@pytest.mark.parametrize("s", [16, 32, 64, 128, 256, 512, 1024])
def test_shared_memory_fits_a_block(s):
    """The kernel's dynamic shared memory at every chunk the wrapper
    takes, with 256 B for its static words, fits a block (232,448 B);
    through s = 256 every row a chunk can touch fits the fold area."""
    k = deferred_pass.fold_rows(s)
    assert deferred_pass.shared_bytes(s) + 256 <= deferred_pass.SMEM_MAX
    assert deferred_pass.SMEM_MAX == 232448
    assert k % 16 == 0 and k >= 16
    assert k == 2 * s or s >= 512


def _fp64_floor_div(a, b):
    """The model passes' floor division (csrc/floor_div.cuh): floor(a *
    (1.0 / b)) in IEEE double, then one correction by the remainder."""
    q = np.floor(a.astype(np.float64) * (1.0 / b.astype(np.float64)))
    q = q.astype(np.int64)
    r = a - q * b
    return q + (r >= b) - (r < 0)


@pytest.mark.parametrize("part", ["small_divisors", "large_divisors"])
def test_fp64_floor_division_is_exact(part):
    """The FP64 floor division equals integer floor division for every
    int32 numerator and positive int32 divisor: every divisor up to 2^16
    against the numerators where an error would show (0, +-1, around
    each end of int32, and the multiples of the divisor nearest 2^31 and
    -2^31, with their neighbours), and a seeded sample of divisors up to
    2^31 - 1 against the same numerators and random ones."""
    rng = np.random.default_rng(13)
    if part == "small_divisors":
        b = np.arange(1, (1 << 16) + 1, dtype=np.int64)
    else:
        b = rng.integers(1 << 16, (1 << 31) - 1, 1 << 16, dtype=np.int64)
    top = ((1 << 31) - 1) // b * b
    bottom = -((1 << 31) // b) * b
    a = np.stack([np.zeros_like(b), np.ones_like(b), -np.ones_like(b),
                  np.full_like(b, (1 << 31) - 1), np.full_like(b, -1 << 31),
                  top, top - 1, top - b, top - b + 1, bottom, bottom + 1,
                  bottom + b - 1, b, b - 1, -b, -b + 1,
                  rng.integers(-1 << 31, 1 << 31, b.shape[0])])
    a = np.clip(a, -1 << 31, (1 << 31) - 1)
    bb = np.broadcast_to(b, a.shape)
    assert np.array_equal(_fp64_floor_div(a, bb), a // bb)
