"""The quality-11 front end of the port (ir/matcher.py and the native
calls under it) against the JAX package: the dictionary index and scan,
the match finders, the command list of build_commands, and the trace
that native.build_trace_cmds makes of it (against both the reference's
C++ call and its Python trace builder).  Every comparison is exact.
Inputs: frames of the sorted divans_tpu sources with a slice of the
vendored dictionary, and numpy-seeded bytes."""
import dataclasses
import glob
import os

import numpy as np
import pytest

from divans_tpu import native as jnative
from divans_tpu.codec import trace as jtrace
from divans_tpu.codec.layout import ModelLayout as JLayout, PROFILES as JP
from divans_tpu.ir import matcher as jmatcher
from divans_tpu.options import DivansOptions as JOptions

from divans_tpu_torch import native
from divans_tpu_torch.codec.layout import ModelLayout, PROFILES
from divans_tpu_torch.ir import commands as cmds
from divans_tpu_torch.ir import matcher
from divans_tpu_torch.options import DivansOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(n: int, seed: int) -> bytes:
    """Source text, a dictionary slice (dense in dictionary words) and
    seeded random bytes."""
    files = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                             recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    d = open(os.path.join(REPO, "divans_tpu", "data", "rfc7932_dict.bin"),
             "rb").read()
    rng = np.random.default_rng(seed)
    k = n // 10
    start = int(rng.integers(0, len(text) - n))
    return (text[start:start + n - 2 * k] + d[20000 + seed:20000 + seed + k]
            + rng.integers(0, 256, k, dtype=np.uint8).tobytes())


@pytest.fixture(scope="module", autouse=True)
def dictionary_indexes():
    """Both packages' dictionary indexes, built once (seconds each, and
    single-threaded: the reference's build is not guarded by a lock)."""
    jmatcher._dict_flat_index()
    matcher._dict_flat_index()


def _as_tuples(commands):
    return [(type(c).__name__, dataclasses.asdict(c)) for c in commands]


def test_dict_index_matches_reference():
    got, ref = matcher._dict_flat_index(), jmatcher._dict_flat_index()
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if isinstance(b, bytes):
            assert a == b
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,seed", [(40000, 1), (3, 2), (0, 3)])
def test_dict_scan_matches_reference(n, seed):
    data = _frame(n, seed) if n > 100 else bytes(range(n))
    out_len, ent_idx = matcher._dict_scan(data)
    j_len, j_idx = jmatcher._dict_scan(data)
    assert np.array_equal(out_len, j_len) and np.array_equal(ent_idx, j_idx)
    if n > 100:
        assert (out_len > 0).sum() > 1000


@pytest.mark.parametrize("quality,n", [(11, 40000), (11, 120000),
                                       (11, 3), (10, 40000)])
def test_find_matches_matches_reference(quality, n):
    """Quality 11 measures the optimal parse against the greedy one on
    the first 96 KiB (the 120,000-byte frame clips both parses there);
    quality 10 takes the optimal parse; 3 bytes hold no match."""
    data = _frame(n, quality) if n > 100 else b"abc"
    got = [list(m) for m in matcher.find_matches(data, quality)]
    assert got == [list(m) for m in jmatcher.find_matches(data, quality)]
    if quality == 11 and n > 100:
        assert any(d == 0 for _p, d, _l in got), "no dictionary edge"


@pytest.mark.parametrize("n,seed,mixing", [(60000, 4, 1), (120000, 5, 1),
                                           (30000, 6, 0)])
def test_build_commands_matches_reference(n, seed, mixing):
    data = _frame(n, seed)
    got = matcher.build_commands(
        data, DivansOptions(quality=11, dynamic_context_mixing=mixing))
    ref = jmatcher.build_commands(
        data, JOptions(quality=11, dynamic_context_mixing=mixing))
    assert _as_tuples(got) == _as_tuples(ref)
    assert sum(isinstance(c, cmds.Dict) for c in got) > 100


@pytest.mark.parametrize("bucketed", [True, False])
def test_build_trace_cmds_matches_reference(bucketed):
    """The port's command list through its FSM binding equals the
    reference's C++ trace and its Python trace builder."""
    data = _frame(24000, 7)
    opts, j_opts = DivansOptions(quality=11), JOptions(quality=11)
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=bucketed)
    j_layout = JLayout(JP["cm"], lo_bucketed=bucketed)
    got = native.build_trace_cmds(data, matcher.build_commands(data, opts),
                                  opts, layout)
    j_cmds = jmatcher.build_commands(data, j_opts)
    assert np.array_equal(got, jnative.build_trace_cmds(data, j_cmds, j_opts,
                                                        j_layout))
    assert np.array_equal(got, jtrace.build_trace(data, j_cmds, j_opts,
                                                  j_layout))


def test_foreign_command_lists_are_refused():
    data = _frame(5000, 8)
    opts = DivansOptions(quality=11)
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=True)
    good = matcher.build_commands(data, opts)
    other_pm = dataclasses.replace(good[0], context_mixing=2)
    assert native.build_trace_cmds(data, [other_pm] + good[1:], opts,
                                   layout) is None
    assert native.build_trace_cmds(data, good + [object()], opts,
                                   layout) is None
    stride = ModelLayout(PROFILES["stride"], lo_bucketed=True)
    assert native.build_trace_cmds(data, good, opts, stride) is None
