"""The adaptive profile's model pass of the port (codec/model_pass) against
the JAX package's: cdf16.blend and weights.update against the numpy
reference on seeded arrays with negative rows, i16 wrap edges and
weights near 2^30; model_pass_plain and model_pass_reference_layout
against jax_engine.model_pass (the reference's XLA scan) on traces of
the port's native.build_trace in the cm, stride and mix profiles and on
chip_smoke.adaptive_edge_traces, the stream lanes against the
reference's host split (jax_engine.py:1031-1040).  All bit-exact.  The
cm traces share one padded shape, so the reference compiles once a
profile.  The kernel's design (csrc/model_pass.cu: row chains, steps in
parallel, weight chains, compaction) is emulated on the host by
tests/adaptive_lanes.py and held to the same lanes, exactly, as is its
table division."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divans_tpu.codec import jax_engine
from divans_tpu.probability import cdf16 as jcdf16
from divans_tpu.probability import weights as jweights

import adaptive_lanes
import chip_smoke
from divans_tpu_torch import native
from divans_tpu_torch.codec import model_pass
from divans_tpu_torch.codec.layout import PROFILES, ModelLayout
from divans_tpu_torch.options import DivansOptions
from divans_tpu_torch.probability import cdf16, weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES, STEPS = 5, 4096     # the shared padded shape of every trace batch


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _data(n: int, seed: int) -> bytes:
    """Sorted divans_tpu sources with a seeded binary tail."""
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(text) - n))
    k = n // 6
    return text[start:start + n - k] + rng.integers(
        0, 256, k, dtype=np.uint8).tobytes()


# ------------------------------------------------- blend and the mixer

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blend_matches_reference(seed):
    """Rows anywhere in int16 (negative, at the wrap edges), bumps up to
    0x7FFF, limits from 0 (renorm every time) to above 0x8000 (never)."""
    rng = np.random.default_rng(seed)
    n = 4000
    cdf = rng.integers(-32768, 32768, (n, 16)).astype(np.int32)
    cdf[: n // 4] = np.sort(cdf[: n // 4], axis=1)
    cdf[n // 4: n // 2, 15] = rng.choice([-32768, -1, 0, 32767], n // 4)
    sym = rng.integers(0, 16, n).astype(np.int32)
    inc = rng.choice([0, 1, 0x30, 0x180, 0x4000, 0x7FFF], n).astype(np.int32)
    lim = rng.choice([0, 64, 0x2000, 0x4000, 0x7FFF, 0x8000, 0x9000],
                     n).astype(np.int32)
    ref = jcdf16.blend(cdf, sym, inc, lim)
    got = cdf16.blend(_t(cdf), _t(sym), _t(inc), _t(lim))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_matches_reference(seed):
    """Weights from 1 to WEIGHT_MAX (the 2^24 rescale and both clamps),
    probabilities from -5 to 40000 (log_geo below 15: the sign-fill
    shift), the sum's int32 wrap."""
    rng = np.random.default_rng(seed)
    n = 6000
    edge = np.array([1, 2, (1 << 24) - 1, 1 << 24, (1 << 30) - 1,
                     (1 << 30) - 2, 1 << 29], np.int32)
    w0 = np.where(rng.random(n) < 0.3, rng.choice(edge, n),
                  rng.integers(1, 1 << 30, n)).astype(np.int32)
    w1 = np.where(rng.random(n) < 0.3, rng.choice(edge, n),
                  rng.integers(1, 1 << 30, n)).astype(np.int32)
    probs = [np.where(rng.random(n) < 0.2,
                      rng.choice([-5, 0, 1, 32767, 32768, 40000], n),
                      rng.integers(1, 32768, n)).astype(np.int32)
             for _ in range(3)]
    ref = jweights.update(w0, w1, *probs)
    got = weights.update(_t(w0), _t(w1), *(_t(p) for p in probs))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


def test_start_freq_matches_xla_on_wrapped_rows():
    """sym_to_start_freq_xla on rows whose max is 0 or negative equals
    the reference's jnp arithmetic (XLA's integer division)."""
    rng = np.random.default_rng(3)
    n = 3000
    cdf = rng.integers(-32768, 32768, (n, 16)).astype(np.int32)
    cdf[: n // 3, 15] = 0
    cdf[n // 3: 2 * n // 3, 15] = rng.integers(-32768, 0, n // 3)
    sym = rng.integers(0, 16, n).astype(np.int32)
    ref = jcdf16.sym_to_start_freq(jnp.asarray(cdf), jnp.asarray(sym),
                                   xp=jnp)
    got = cdf16.sym_to_start_freq_xla(_t(cdf), _t(sym))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ------------------------------------------------------------- the pass

def _padded(traces):
    """Traces as the reference pads them, at the shared [LANES, STEPS]."""
    flat, n_steps = model_pass.pack_traces(traces)
    tr = model_pass.padded(_t(flat), _t(n_steps)).numpy()
    assert tr.shape[0] <= LANES and tr.shape[1] <= STEPS, tr.shape
    out = np.zeros((LANES, STEPS, 10), np.int32)
    out[:, :, 2] = -1
    out[:, :, 4] = out[:, :, 9] = model_pass.NOOP_LIM
    out[:tr.shape[0], :tr.shape[1]] = tr
    return out


def _check(traces, num_rows, reference_layout: bool = False):
    """The plain pass's lanes (and, when asked, its reference layout,
    padding steps included) against jax_engine.model_pass."""
    tr = _padded(traces)
    js, jf = (np.asarray(a) for a in jax_engine.model_pass(jnp.asarray(tr),
                                                            num_rows))
    if reference_layout:
        st, fr = model_pass.model_pass_reference_layout(_t(tr), num_rows)
        np.testing.assert_array_equal(st.numpy(), js)
        np.testing.assert_array_equal(fr.numpy(), jf)
    # the lanes against the reference's host split of its own output
    flat, n_steps = model_pass.pack_traces(traces)
    n_lane = max(1, max(max(model_pass.lane_counts(t)) for t in traces))
    ls, lf, counts = model_pass.model_pass_plain(_t(flat), _t(n_steps),
                                                 num_rows, n_lane)
    for i, t in enumerate(traces):
        n = t.shape[0]
        for sid in (0, 1):
            m = t[:, 2] == sid
            k = int(m.sum())
            lane = 2 * i + sid
            assert int(counts[lane]) == k
            np.testing.assert_array_equal(ls[lane, :k].numpy(), js[i, :n][m])
            np.testing.assert_array_equal(lf[lane, :k].numpy(), jf[i, :n][m])
            assert (ls[lane, k:] == 0).all() and (lf[lane, k:] == 1).all()


@pytest.mark.parametrize("profile,kw", [
    ("cm", {}), ("cm", dict(dynamic_context_mixing=0)),
    ("cm", dict(dynamic_context_mixing=2)),
    ("stride", dict(use_context_map=False)),
    ("mix", dict(force_stride_value=4))],
    ids=["cm", "cm-dcm0", "cm-dcm2", "stride", "mix"])
def test_model_pass_matches_reference(profile, kw):
    """Frame traces of the port's native.build_trace (the trace FSM of
    the reference's native.build_trace) at the adaptive layout."""
    layout = ModelLayout(PROFILES[profile], lo_bucketed=False)
    opts = DivansOptions(**kw)
    data = _data(3 * 1500, seed=len(kw))
    traces = [native.build_trace(data[o:o + 1500], opts, layout)
              for o in range(0, len(data), 1500)]
    for t in traces:
        model_pass.check_trace(t, layout.num_rows)
    assert any((t[:, 5] != 0).any() for t in traces) == (
        kw.get("dynamic_context_mixing", 1) != 0)
    _check(traces, layout.num_rows)


def test_model_pass_edge_traces_match_reference():
    """chip_smoke.adaptive_edge_traces over the cm layout's rows: nibble
    and cm rows that coincide (the cm blend stays), padding steps among
    the steps, the weight clamps, rows with a max of 0 or below."""
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=False)
    traces = chip_smoke.adaptive_edge_traces(layout.num_rows)
    coincide = traces[0]
    assert (coincide[:, 0] == coincide[:, 7]).sum() >= 1000
    assert (traces[1][:, 2] == -1).sum() > 0
    _check(traces, layout.num_rows, reference_layout=True)


def test_check_trace_refuses_out_of_contract_steps():
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=False)
    good = chip_smoke.adaptive_edge_traces(layout.num_rows)[0]
    model_pass.check_trace(good, layout.num_rows)
    for col, bad in ((0, layout.num_rows), (7, -1), (1, 16), (6, 2),
                     (2, 2)):
        t = good.copy()
        t[5, col] = bad
        with pytest.raises(ValueError, match=f"column {col}"):
            model_pass.check_trace(t, layout.num_rows)


def test_model_pass_empty_and_ragged_frames():
    """No frame, then frames of 0 steps beside others: empty lanes,
    counts 0, padding columns (start 0, freq 1)."""
    st, fr, counts = model_pass.model_pass_plain(
        torch.zeros((0, 10), dtype=torch.int32),
        torch.zeros((0,), dtype=torch.int32), 100, 4)
    assert st.shape == (0, 4) and counts.shape == (0,)
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=False)
    t = chip_smoke.adaptive_edge_traces(layout.num_rows)[2][:50]
    flat, n_steps = model_pass.pack_traces([np.zeros((0, 10), np.int32), t])
    st, fr, counts = model_pass.model_pass_plain(_t(flat), _t(n_steps),
                                                 layout.num_rows, 64)
    assert counts.tolist()[:2] == [0, 0]
    assert (st[:2] == 0).all() and (fr[:2] == 1).all()
    assert int(counts[2] + counts[3]) == 50


# ------------------------------ the kernel's row chains and weight chain

def _lanes_check(traces, num_rows):
    """tests/adaptive_lanes.py's emulation of csrc/model_pass.cu (row
    chains over staged tiles, steps in parallel, one weight chain a mixer,
    compaction) against model_pass_plain and jax_engine.model_pass's
    host split, exactly.  Returns the chain steps each owner ran."""
    flat, n_steps = model_pass.pack_traces(traces)
    n_lane = max(1, max(max(model_pass.lane_counts(t)) for t in traces))
    st, fr, counts, ran = adaptive_lanes.model_pass_lanes(traces, num_rows,
                                                         n_lane)
    ps, pf, pc = model_pass.model_pass_plain(_t(flat), _t(n_steps), num_rows,
                                             n_lane)
    np.testing.assert_array_equal(st, ps.numpy())
    np.testing.assert_array_equal(fr, pf.numpy())
    np.testing.assert_array_equal(counts, pc.numpy())
    js, jf = (np.asarray(a) for a in jax_engine.model_pass(
        jnp.asarray(_padded(traces)), num_rows))
    for i, t in enumerate(traces):
        for sid in (0, 1):
            m = t[:, 2] == sid
            k = int(m.sum())
            np.testing.assert_array_equal(st[2 * i + sid, :k],
                                          js[i, :t.shape[0]][m])
            np.testing.assert_array_equal(fr[2 * i + sid, :k],
                                          jf[i, :t.shape[0]][m])
    return ran


@pytest.mark.parametrize("profile,kw", [
    ("cm", {}), ("cm", dict(dynamic_context_mixing=0)),
    ("stride", dict(use_context_map=False)),
    ("mix", dict(force_stride_value=4))],
    ids=["cm", "cm-dcm0", "stride", "mix"])
def test_row_chains_match_reference(profile, kw):
    """The kernel's decomposition on frame traces of native.build_trace.
    Without mixing, every step's cm blend goes to the frozen row 0 with
    inc 0 and no step reads it: the chains skip all of them, so they run
    exactly one event a step."""
    layout = ModelLayout(PROFILES[profile], lo_bucketed=False)
    opts = DivansOptions(**kw)
    data = _data(3 * 1500, seed=10 + len(kw))
    traces = [native.build_trace(data[o:o + 1500], opts, layout)
              for o in range(0, len(data), 1500)]
    ran = _lanes_check(traces, layout.num_rows)
    n_mix = [int((t[:, 5] != 0).sum()) for t in traces]
    if not any(n_mix):
        assert ran.sum(1).tolist() == [t.shape[0] for t in traces]


@pytest.mark.parametrize("profile", ["cm", "mix"])
def test_row_chains_edge_traces(profile):
    """chip_smoke.adaptive_edge_traces over the cm rows (the model in
    shared memory) and the mix rows (the global slab): nibble and cm rows
    that coincide (one event, the cm blend's, recording both reads),
    padding steps, the weight clamps, rows with a max of 0 or below."""
    r = ModelLayout(PROFILES[profile], lo_bucketed=False).num_rows
    traces = chip_smoke.adaptive_edge_traces(r)
    assert (traces[0][:, 0] == traces[0][:, 7]).any()
    _lanes_check(traces, r)


def test_div_table_is_exact():
    """csrc/adaptive.cuh's xdiv: floor(a / b) by the table entry m =
    ceil(2^(31 + L) / |b|), L = floor(log2 |b|), one 32 x 32 -> 64-bit
    multiply and a shift, for every divisor an int16 row max can be (0
    and negatives as XLA divides) and numerators c << 15 of every sign
    and size, equals Python's floor division."""
    table = [int(x) for x in model_pass.div_table_np()]
    assert all(1 << 30 < m <= 1 << 31 for m in table[1:])
    rng = np.random.default_rng(15)

    def xdiv(a, b):
        if b == 0:
            return -1 if a == 0 else -2
        d, x = abs(b), (-a if b < 0 else a)
        s = x if x >= 0 else ~x
        q = (s * table[d]) >> (30 + d.bit_length())
        return q if x >= 0 else ~q

    for b in range(-(1 << 15), 1 << 15):
        cs = [-(1 << 15), -1, 0, 1, (1 << 15) - 1,
              int(rng.integers(-(1 << 15), 1 << 15))]
        for c in cs + [b, b - 1, b + 1]:
            a = (c << 15) if -(1 << 15) <= c <= 1 << 15 else 0
            want = (-1 if a == 0 else -2) if b == 0 else a // b
            assert xdiv(a, b) == want, (a, b)

