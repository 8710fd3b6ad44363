"""The encode's cmd-stream model pass of the port (codec/cmd_pass.py)
against the JAX package: cmd_pass_plain (the plain version of
csrc/cmd_pass.cu) against the XLA pass
jax_engine.model_pass_deferred_cmd and the Pallas kernel
pallas_cmd_pass.model_pass_cmd_pallas in interpret mode, on real
quality-10 and quality-11 cmd traces and on seeded renorm-heavy ones;
the stream split, the row speeds and the packing against the
reference's.  Every comparison is bit-exact (integer codec: tolerance
zero).  Inputs: the sorted divans_tpu sources, a slice of the vendored
dictionary and numpy-seeded traces."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divans_tpu import native as jnative
from divans_tpu.codec import jax_engine
from divans_tpu.codec import pallas_cmd_pass as pcp
from divans_tpu.codec.layout import ModelLayout as JLayout, PROFILES as JP
from divans_tpu.ir import matcher as jmatcher
from divans_tpu.options import DivansOptions as JOptions

from divans_tpu_torch.codec import cmd_pass, encode
from divans_tpu_torch.codec.deferred import MAX_RENORM_PASSES, cmd_chunk
from divans_tpu_torch.codec.layout import ModelLayout, PROFILES
from divans_tpu_torch.probability import cdf16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JLAYOUT = JLayout(JP["cm"], lo_bucketed=True)
LAYOUT = ModelLayout(PROFILES["cm"], lo_bucketed=True)
S = cmd_chunk(256)


def _data(n: int, seed: int) -> bytes:
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    d = open(os.path.join(REPO, "divans_tpu", "data", "rfc7932_dict.bin"),
             "rb").read()
    k = n // 8
    return (text[seed * 7000:seed * 7000 + n - k]
            + d[50000 + seed:50000 + seed + k])


def _traces(quality: int, n_blocks: int = 3, mb: int = 8192, seed: int = 0):
    """The reference's frame traces: the mechanical FSM at quality 10,
    the matcher's command list through the FSM at quality 11."""
    opts = JOptions(quality=quality, metablock_size=mb, chunk_nibbles=256)
    data = _data(n_blocks * mb, seed)
    blocks = [data[o:o + mb] for o in range(0, n_blocks * mb, mb)]
    if quality < 11:
        return [jnative.build_trace(b, opts, JLAYOUT) for b in blocks]
    return [jnative.build_trace_cmds(b, jmatcher.build_commands(b, opts),
                                     opts, JLAYOUT) for b in blocks]


def _cmd_ts(traces):
    cmd_ts, _l, _m, r_cmd, _rl = jax_engine.split_stream_traces(traces,
                                                                JLAYOUT)
    return cmd_ts, r_cmd


def _xla(cmd_ts, inc_row, lim_row, r_cmd):
    pad = jnp.asarray(jax_engine._pad_traces(cmd_ts, multiple=S))
    st, fr = jax_engine.model_pass_deferred_cmd(
        pad, jnp.asarray(inc_row), jnp.asarray(lim_row), r_cmd, S)
    return np.asarray(st), np.asarray(fr)


def _port(cmd_ts, inc_row, lim_row, n_padded):
    rows = [cmd_pass.pack_cmd_rows(t) for t in cmd_ts]
    b = len(rows)
    n_steps = np.array([len(r) for r in rows], np.int32)
    st, fr = cmd_pass.cmd_pass(
        torch.from_numpy(cmd_pass.assemble_cmd_rows(rows, n_padded)),
        torch.from_numpy(np.tile(inc_row, (b, 1))),
        torch.from_numpy(np.tile(lim_row, (b, 1))),
        torch.from_numpy(n_steps), S)
    return st.numpy(), fr.numpy(), n_steps


def _compare(cmd_ts, inc_row, lim_row, r_cmd, pallas: bool = True):
    """cmd_pass_plain == the XLA pass (and the Pallas kernel) on every
    lane up to its step count; 0 past it."""
    st_x, fr_x = _xla(cmd_ts, inc_row, lim_row, r_cmd)
    n_padded = st_x.shape[1]
    st, fr, n_steps = _port(cmd_ts, inc_row, lim_row, n_padded)
    refs = [(st_x, fr_x)]
    if pallas:
        st_p, fr_p = pcp.model_pass_cmd_pallas(cmd_ts, inc_row, lim_row,
                                               r_cmd, S, n_padded,
                                               interpret=True)
        refs.append((np.asarray(st_p), np.asarray(fr_p)))
    assert st.shape == st_x.shape
    for i, k in enumerate(n_steps):
        for st_r, fr_r in refs:
            assert np.array_equal(st[i, :k], st_r[i, :k]), i
            assert np.array_equal(fr[i, :k], fr_r[i, :k]), i
        assert not st[i, k:].any() and not fr[i, k:].any()


@pytest.mark.parametrize("quality", [10, 11])
def test_plain_matches_xla_and_pallas(quality):
    """Real cmd traces, tens of chunks a lane: the lag, the hit-row
    limits and the renorm passes all come into play."""
    cmd_ts, r_cmd = _cmd_ts(_traces(quality, seed=quality))
    assert min(t.shape[0] for t in cmd_ts) >= 20 * S
    inc_row, lim_row = jax_engine.cmd_speeds_from_rows(cmd_ts, r_cmd)
    _compare(cmd_ts, inc_row, lim_row, r_cmd)


def test_nonmultiple_batch_and_empty_lane():
    """Five lanes (not a multiple of the TPU's 8): two frames, an empty
    lane, three whole chunks of a frame and a 7-step lane."""
    cmd_ts, r_cmd = _cmd_ts(_traces(11, seed=4))
    inc_row, lim_row = jax_engine.cmd_speeds_from_rows(cmd_ts, r_cmd)
    cmd_ts = [cmd_ts[0], np.zeros((0, 10), np.int32), cmd_ts[1],
              cmd_ts[2][:S * 3], cmd_ts[0][:7]]
    _compare(cmd_ts, inc_row, lim_row, r_cmd)


@pytest.mark.parametrize("inc,lim", [(1024, 8192), (700, 4096)])
def test_renorm_heavy_speeds(inc, lim):
    """Fast adaptation forces several renorm passes a commit."""
    rng = np.random.default_rng(7)
    r_cmd = 19
    cmd_ts = []
    for _ in range(9):
        n = int(rng.integers(1, 5 * S))
        t = np.zeros((n, 10), np.int32)
        t[:, 0] = rng.integers(0, r_cmd, n)       # rows
        t[:, 1] = rng.integers(0, 16, n)          # nibbles
        t[:, 3] = inc
        t[:, 4] = lim
        cmd_ts.append(t)
    _compare(cmd_ts, np.full(r_cmd, inc, np.int32),
             np.full(r_cmd, lim, np.int32), r_cmd)


def test_per_lane_speed_tables():
    """Each lane brings its own speed table: a batch of lanes with
    different speeds equals one pass per lane."""
    rng = np.random.default_rng(8)
    r_cmd = 11
    lanes = []
    for inc, lim in ((1024, 8192), (16, 0x2000), (700, 4096)):
        n = int(rng.integers(3 * S, 5 * S))
        t = np.zeros((n, 10), np.int32)
        t[:, 0] = rng.integers(0, r_cmd, n)
        t[:, 1] = rng.integers(0, 16, n)
        t[:, 3] = inc
        t[:, 4] = lim
        lanes.append((t, np.full(r_cmd, inc, np.int32),
                      np.full(r_cmd, lim, np.int32)))
    n_padded = 5 * S
    rows = [cmd_pass.pack_cmd_rows(t) for t, _i, _l in lanes]
    st, fr = cmd_pass.cmd_pass(
        torch.from_numpy(cmd_pass.assemble_cmd_rows(rows, n_padded)),
        torch.from_numpy(np.stack([i for _t, i, _l in lanes])),
        torch.from_numpy(np.stack([lm for _t, _i, lm in lanes])),
        torch.from_numpy(np.array([len(r) for r in rows], np.int32)), S)
    for k, (t, inc_row, lim_row) in enumerate(lanes):
        st_x, fr_x = _xla([t], inc_row, lim_row, r_cmd)
        n = t.shape[0]
        assert np.array_equal(st[k, :n].numpy(), st_x[0, :n])
        assert np.array_equal(fr[k, :n].numpy(), fr_x[0, :n])


def test_step_counts_clamped_to_the_row():
    """A step count past N (or below 0) is clamped to [0, N]: the
    outputs equal those of the lane's true count, N or 0."""
    rng = np.random.default_rng(9)
    r_cmd = 13
    n_padded = 3 * S
    t = np.zeros((n_padded, 10), np.int32)
    t[:, 0] = rng.integers(0, r_cmd, n_padded)
    t[:, 1] = rng.integers(0, 16, n_padded)
    t[:, 3], t[:, 4] = 700, 4096
    row = cmd_pass.pack_cmd_rows(t)
    packed = torch.from_numpy(cmd_pass.assemble_cmd_rows([row, row],
                                                         n_padded))
    inc = torch.full((2, r_cmd), 700, dtype=torch.int32)
    lim = torch.full((2, r_cmd), 4096, dtype=torch.int32)

    def run(counts):
        return cmd_pass.cmd_pass_plain(
            packed, inc, lim, torch.tensor(counts, dtype=torch.int32), S)

    st, fr = run([n_padded + 5 * S, -3])
    st_x, fr_x = run([n_padded, 0])
    assert torch.equal(st, st_x) and torch.equal(fr, fr_x)
    assert fr[0].all() and not st[1].any() and not fr[1].any()
    ref_st, ref_fr = _xla([t], np.full(r_cmd, 700, np.int32),
                          np.full(r_cmd, 4096, np.int32), r_cmd)
    assert np.array_equal(st[0].numpy(), ref_st[0, :n_padded])
    assert np.array_equal(fr[0].numpy(), ref_fr[0, :n_padded])


def test_split_and_speeds_match_reference():
    """split_stream_traces and cmd_speeds_from_rows equal the
    reference's; a row seen at two speeds, or a mixing step, gives
    None."""
    traces = _traces(11, n_blocks=2, seed=5)
    ref = jax_engine.split_stream_traces(traces, JLAYOUT)
    got = encode.split_stream_traces(traces, LAYOUT)
    for a, b in zip(got[:3], ref[:3]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert got[3:] == ref[3:]
    cmd_ts, r_cmd = got[0], got[3]
    for ts in (cmd_ts, cmd_ts[:1]):
        inc, lim = cmd_pass.cmd_speeds_from_rows(ts, r_cmd)
        j_inc, j_lim = jax_engine.cmd_speeds_from_rows(ts, r_cmd)
        assert np.array_equal(inc, j_inc) and np.array_equal(lim, j_lim)
        assert inc.dtype == lim.dtype == np.int32
    clash = cmd_ts[1].copy()
    live = np.nonzero(clash[:, 3])[0]
    clash[live[-1], 0] = clash[live[0], 0]
    clash[live[-1], 3] = clash[live[0], 3] + 1
    mixing = cmd_ts[1].copy()
    mixing[0, 5] = 1
    for bad in (clash, mixing):
        assert cmd_pass.cmd_speeds_from_rows([cmd_ts[0], bad], r_cmd) is None
        assert jax_engine.cmd_speeds_from_rows([cmd_ts[0], bad],
                                               r_cmd) is None


def test_packing_matches_reference():
    """The port's [B, N] uint16 steps equal the TPU kernel's packed
    [NG, C, S, G] planes carried across (11 lanes: two 8-lane groups,
    the last one padded)."""
    cmd_ts, _r = _cmd_ts(_traces(11, n_blocks=3, seed=6))
    cmd_ts = cmd_ts + [t[:100] for t in cmd_ts] + [cmd_ts[0][:0]] \
        + cmd_ts[:4]
    b = len(cmd_ts)
    n_padded = -(-max(t.shape[0] for t in cmd_ts) // S) * S
    packed = cmd_pass.assemble_cmd_rows(
        [cmd_pass.pack_cmd_rows(t) for t in cmd_ts], n_padded)
    tpu = cmd_pass.from_tpu_cmd_planes(
        pcp.pack_cmd_traces(cmd_ts, n_padded, S))
    assert packed.dtype == np.uint16 and tpu.shape == (16, n_padded)
    assert np.array_equal(tpu[:b], packed) and not tpu[b:].any()


def test_pack_rejects_rows_past_the_kernel():
    t = np.zeros((3, 10), np.int32)
    t[1, 0] = cmd_pass.MAX_ROWS
    with pytest.raises(ValueError):
        cmd_pass.pack_cmd_rows(t)


# ---- the kernel's sparse commit, modelled in numpy -------------------------

INIT = 4 * np.arange(1, 17, dtype=np.int64)


def _i32(x):
    """int64 values wrapped to int32, kept as int64."""
    return (np.asarray(x, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)


def _sparse_commit_model(cmd_ts, inc_row, lim_row, s):
    """csrc/cmd_pass.cu's commit rule, lane by lane, in numpy: at the end
    of chunk c only the rows chunk c-1 counted and the rows whose last
    commit left entry 15 at or above 0x8000 (the `over` rows) commit;
    every other row keeps its values.  Returns ([(starts, freqs)] per
    lane, the commits of over rows chunk c-1 did not count)."""
    r = inc_row.shape[0]
    out, over_only = [], 0
    for t in cmd_ts:
        n = t.shape[0]
        model = np.tile(INIT, (r, 1))
        cnt = np.zeros((2, r, 16), np.int64)
        counted = [set(), set()]
        over = set()
        starts = np.zeros(n, np.int64)
        freqs = np.zeros(n, np.int64)
        for c in range(-(-n // s)):
            par, pp = c & 1, (c & 1) ^ 1
            x = t[c * s:(c + 1) * s]
            act = x[:, 3] != 0
            rows = np.where(act[:, None], model[x[:, 0]], INIT)
            st, fr = cdf16.sym_to_start_freq(
                torch.from_numpy(rows.astype(np.int32)),
                torch.from_numpy(x[:, 1].astype(np.int32)))
            starts[c * s:c * s + x.shape[0]] = st.numpy()
            freqs[c * s:c * s + x.shape[0]] = fr.numpy()
            for row, sym in x[act][:, :2]:
                cnt[par, row, sym] += 1
                counted[par].add(int(row))
            over_only += len(over - counted[pp])
            for row in sorted(counted[pp] | over):
                cum = np.cumsum(cnt[pp, row])
                v = _i32(model[row] + _i32(int(inc_row[row]) * cum))
                lim_eff = lim_row[row] if cum[15] > 0 else 0x8000
                for _ in range(MAX_RENORM_PASSES):
                    if v[15] < lim_eff:
                        break
                    cb = _i32(v + np.arange(1, 17))
                    v = cb - (cb >> 2)
                model[row] = v
                cnt[pp, row] = 0
                (over.add if v[15] >= 0x8000 else over.discard)(row)
            counted[pp] = set()
        out.append((starts, freqs))
    return out, over_only


def _turn_lane(rng, n, r_rows):
    """A cmd trace whose chunk c hits only the rows r with r % 3 == c % 3
    (four of them): a row is coded against two commits after its chunk,
    once it has been committed both as counted and as untouched."""
    t = np.zeros((n, 10), np.int32)
    chunk_of = np.arange(n) // S
    t[:, 0] = 3 * rng.integers(0, 4, n) + chunk_of % 3
    t[:, 1] = rng.integers(0, 16, n)
    assert t[:, 0].max() < r_rows
    return t


@pytest.mark.parametrize("inc,lim", [(512, 0xA000), (1 << 22, 0x8000)],
                         ids=["lim_above_0x8000", "renorm_cap"])
def test_sparse_commit_matches_xla_and_plain(inc, lim):
    """The kernel's sparse commit (counted rows plus the over rows),
    modelled in numpy, equals the XLA model_pass_deferred_cmd and
    cmd_pass_plain (the dense rule) where commits leave entry 15 at or
    above 0x8000: with lim above 0x8000, and with inc so large that
    rows hit the 24-pass cap still above it.  Rows take turns, so a row
    is coded against only once both commits have brought it below 2^15
    (the XLA pass's exact row fetch); rows counted at other speeds fill
    the rest of the 256-row model."""
    rng = np.random.default_rng(30)
    r = cmd_pass.MAX_ROWS
    inc_row = np.full(r, inc, np.int32)
    lim_row = np.full(r, lim, np.int32)
    inc_row[12:], lim_row[12:] = 24, 0x2000
    turns = _turn_lane(rng, 30 * S, r)
    wide = np.zeros((9 * S + 5, 10), np.int32)
    wide[:, 0] = rng.integers(12, r, wide.shape[0])
    wide[:, 1] = rng.integers(0, 16, wide.shape[0])
    cmd_ts = [turns, wide]
    for t in cmd_ts:
        t[:, 3] = inc_row[t[:, 0]]
        t[:, 4] = lim_row[t[:, 0]]
    t = turns.copy()
    t[rng.random(t.shape[0]) < 0.2, 3] = 0      # inactive steps
    cmd_ts.append(t)
    got, over_only = _sparse_commit_model(cmd_ts, inc_row, lim_row, S)
    assert over_only >= 8, "few rows committed for their entry 15 alone"
    st_x, fr_x = _xla(cmd_ts, inc_row, lim_row, r)
    st, fr, _n = _port(cmd_ts, inc_row, lim_row, st_x.shape[1])
    for i, t in enumerate(cmd_ts):
        k = t.shape[0]
        assert np.array_equal(got[i][0], st_x[i, :k]), i
        assert np.array_equal(got[i][1], fr_x[i, :k]), i
        assert np.array_equal(st[i, :k], st_x[i, :k]), i
        assert np.array_equal(fr[i, :k], fr_x[i, :k]), i


def test_sparse_commit_matches_xla_on_real_traces():
    """The sparse commit model on real quality-11 cmd traces (no row
    there ever reaches 0x8000, so only counted rows commit)."""
    cmd_ts, r_cmd = _cmd_ts(_traces(11, n_blocks=2, seed=12))
    inc_row, lim_row = jax_engine.cmd_speeds_from_rows(cmd_ts, r_cmd)
    got, _o = _sparse_commit_model(cmd_ts, inc_row, lim_row, S)
    st_x, fr_x = _xla(cmd_ts, inc_row, lim_row, r_cmd)
    for i, t in enumerate(cmd_ts):
        k = t.shape[0]
        assert np.array_equal(got[i][0], st_x[i, :k]), i
        assert np.array_equal(got[i][1], fr_x[i, :k]), i


def test_shared_memory_fits_a_block():
    """The kernel's dynamic shared memory fits a block (232,448 B) with
    room for its static words, for every s it takes (one size)."""
    assert cmd_pass.SHARED_BYTES == 84096
    assert cmd_pass.SHARED_BYTES + 256 <= 232448
