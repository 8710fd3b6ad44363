"""The encode's literal model pass of the port (codec/lit_pass.py)
against the JAX package: the native packer against pack_lit_row, the
port's lane layout against assemble_lit_planes, and lit_pass_plain (the
plain version of csrc/lit_pass.cu) against the XLA lit pass
jax_engine.model_pass_deferred_lit and, once, against the Pallas kernel
in interpret mode.  Every comparison is bit-exact (integer codec:
tolerance zero).  Inputs: the sorted divans_tpu sources, a slice of the
vendored dictionary and numpy-seeded bytes."""
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

from divans_tpu_torch import native
from divans_tpu_torch.codec import lit_pass

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
