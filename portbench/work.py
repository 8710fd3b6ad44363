"""The yardstick's arithmetic: the H100's peaks and the work that the
adaptive kernels' inputs need, copied from chip_smoke.py
(`_model_pass_work`, `_scan_work` and their prices).

Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet and the
Hopper whitepaper): HBM at 3.35 TB/s; INT32 at 132 SMs x 64 INT32 lanes
x the 1.98 GHz boost clock, one operation a lane a clock.  A card set
below 700 W runs slower under load, so every run prints the card's
power limit beside its rooflines.
"""
from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# the model pass ~230 a step (the trace row, two row gathers, one
# reciprocal and two floor divisions for (start, freq), two 16-entry
# blends at ~6 an entry, two row stores, the lane store) and ~170 more a
# mixing step; the decode scan ~230 a coded nibble, ~370 more a nibble
# that mixes, and ~30 a copy micro-step (one for each 8 bytes the
# literals did not write)
MODEL_PASS_OPS_PER_STEP = 230
MODEL_PASS_OPS_PER_MIX_STEP = 170
SCAN_OPS_PER_NIBBLE = 230
SCAN_OPS_PER_MIX_NIBBLE = 370
SCAN_OPS_PER_COPY_STEP = 30


class Frame(NamedTuple):
    raw_len: int
    cmd: bytes
    lit: bytes


def model_pass_work(traces):
    """(bytes, operations) the model pass needs on these traces: each
    step's 40 B of trace read once, each coded step's (start, freq) and
    the counts written once; MODEL_PASS_OPS_PER_STEP a step and
    MODEL_PASS_OPS_PER_MIX_STEP more a mixing one."""
    n = sum(t.shape[0] for t in traces)
    n_out = sum(int((t[:, 2] >= 0).sum()) for t in traces)
    n_mix = sum(int((t[:, 5] != 0).sum()) for t in traces)
    b = len(traces)
    return (40 * n + 4 * b + 8 * n_out + 8 * b,
            MODEL_PASS_OPS_PER_STEP * n + MODEL_PASS_OPS_PER_MIX_STEP * n_mix)


def scan_work(frames, traces, wpos):
    """(bytes, operations) the scan needs on these frames: their streams
    read once, their window bytes, ok and wpos written once;
    SCAN_OPS_PER_NIBBLE a coded nibble (the encode trace's steps),
    SCAN_OPS_PER_MIX_NIBBLE more a mixing one, SCAN_OPS_PER_COPY_STEP a
    copy micro-step, one for each 8 bytes the literals did not write.  A
    frame the scan flags counts the share of this its wpos reached."""
    n_bytes = n_ops = 0.0
    for f, t, w in zip(frames, traces, list(wpos)):
        share = min(1.0, w / max(f.raw_len, 1))
        lit = int((t[:, 2] == 1).sum()) // 2
        n_bytes += share * (len(f.cmd) + len(f.lit) + f.raw_len) + 9
        n_ops += share * (
            SCAN_OPS_PER_NIBBLE * t.shape[0]
            + SCAN_OPS_PER_MIX_NIBBLE * int((t[:, 5] != 0).sum())
            + SCAN_OPS_PER_COPY_STEP * (-(-(f.raw_len - lit) // 8)))
    return int(n_bytes), int(n_ops)


def bound_seconds(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(the least time the card could take, what bounds it)."""
    t_ops = n_ops / INT32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
