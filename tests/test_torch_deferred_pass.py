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

from divans_tpu_torch.codec import deferred_pass, encode
from divans_tpu_torch.codec.deferred import cmd_chunk
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
