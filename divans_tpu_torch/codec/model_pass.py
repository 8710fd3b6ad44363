"""The adaptive profile's per-nibble model pass (chunk_nibbles=0): the
CUDA kernel, its wrapper and its plain PyTorch version.

`model_pass` is the port of the reference's XLA scan
divans_tpu/codec/jax_engine.py:77 (`model_pass`; no Pallas kernel) with
the host split of its output by stream (:1031-1040) folded in.  On a
CUDA tensor it launches csrc/model_pass.cu (built by cuda_build with
nvcc for sm_90a at first use, bound through ctypes): two launches, the
row chains with every step's weight-free work, then the weight chains;
or it raises.  On a CPU tensor it runs `model_pass_plain`, the scan in
PyTorch with every frame in lockstep, a loop over steps.

Layout: the frames' traces back to back, trace int32 [T, 10]
(codec/trace.py's columns: flat, value, stream, inc, lim, mix, which,
cm_idx, cm_inc, cm_lim) with n_steps int32 [B] steps a frame, give
starts, freqs int32 [2B, n_lane] and counts int32 [2B]: lane 2b is frame
b's cmd stream (its stream-0 steps' (start, freq) in order), lane 2b + 1
its lit stream; columns past a lane's count are start 0, freq 1 (the
rANS encode's padding).  `model_pass_reference_layout` gives the
reference's own [B, N] (start, freq) of every step of padded [B, N, 10]
traces, for the tests.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_build
from ..probability import cdf16
from ..probability.weights import NORM_WEIGHT_INIT, update

NAME = "model_pass"
_SIGNATURES = {"dtpu_model_pass": [ctypes.c_void_p] * 3
               + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 12,
               "dtpu_model_pass_max_shared": []}
NCOLS = 10
NOOP_LIM = 0x4000              # a padding step's lim: row 0 stays CDF_INIT
MAX_SHARED_MODEL = 196608      # csrc/adaptive.cuh kMaxShared
MAX_ROWS = 1 << 15             # a row index takes 15 bits of a staged event

# kernel launches, counted where the wrapper launches (and nowhere else)
LAUNCHES = 0


def build():
    """csrc/model_pass.cu, compiled for sm_90a at first use, loaded."""
    return cuda_build.load(NAME, _SIGNATURES)


DIV_TABLE_LEN = (1 << 15) + 1   # every divisor: a row's max, 1 .. 2^15


def div_table_np() -> np.ndarray:
    """uint32 [DIV_TABLE_LEN]: at each d >= 1, ceil(2^(31 + L) / d) with
    L = floor(log2 d) (0 at 0), the adaptive kernels' exact floor division
    by an int16 row max (csrc/adaptive.cuh Recip, xdiv)."""
    out = np.zeros(DIV_TABLE_LEN, np.uint32)
    out[1:] = [-(-(1 << (30 + d.bit_length())) // d)
               for d in range(1, DIV_TABLE_LEN)]
    return out


@functools.lru_cache(maxsize=None)
def div_table(device) -> torch.Tensor:
    """div_table_np on `device` (its bits as int32), made once a device."""
    return torch.from_numpy(div_table_np().view(np.int32)).to(device)


def model_in_shared(num_rows: int) -> bool:
    """Does a frame's model (num_rows x 32 B) live in the shared memory of
    the adaptive kernels (this one and the decode scan)?  (cm and stride:
    yes; mix: no, a global slab.)"""
    return num_rows * 32 <= MAX_SHARED_MODEL


def check_trace(t: np.ndarray, num_rows: int) -> None:
    """Raise unless every step of a frame's trace is in the kernel's
    contract: rows in [0, num_rows), values in [0, 16), which in {0, 1}
    and stream in {-1, 0, 1} (the reference's gathers would clamp what
    the kernel must not read)."""
    if t.ndim != 2 or t.shape[1] != NCOLS:
        raise ValueError(f"trace of shape {t.shape}, expected [n, {NCOLS}]")
    if not t.shape[0]:
        return
    lo, hi = t.min(axis=0), t.max(axis=0)
    for col, low, high in ((0, 0, num_rows - 1), (7, 0, num_rows - 1),
                           (1, 0, 15), (6, 0, 1), (2, -1, 1)):
        if lo[col] < low or hi[col] > high:
            raise ValueError(f"trace column {col} outside [{low}, {high}]")


def lane_counts(t: np.ndarray) -> tuple[int, int]:
    """(cmd steps, lit steps) of a frame's trace."""
    s = t[:, 2]
    return int(np.count_nonzero(s == 0)), int(np.count_nonzero(s == 1))


def pack_traces(traces: list[np.ndarray]):
    """Frames' traces back to back: (trace int32 [T, 10], n_steps int32
    [B])."""
    n_steps = np.array([t.shape[0] for t in traces], np.int32)
    flat = (np.concatenate(traces).astype(np.int32, copy=False) if traces
            else np.zeros((0, NCOLS), np.int32))
    return np.ascontiguousarray(flat), n_steps


def model_pass(trace, n_steps, num_rows: int, n_lane: int):
    """(starts, freqs, counts) of every frame's steps, split into their
    stream lanes.  n_lane: the lane width, at least the longest stream
    (columns past it are not written)."""
    if trace.device.type == "cpu":
        return model_pass_plain(trace, n_steps, num_rows, n_lane)
    return _launch(trace, n_steps, num_rows, n_lane, None)


def model_pass_phases(trace, n_steps, num_rows: int, n_lane: int):
    """model_pass's launches on the card, with each frame's phases timed
    on the card's clock: ((starts, freqs, counts), ns int64 [B, 3]), the
    row chains, the steps in parallel and the longer of the two weight
    chains (%globaltimer from each block's start)."""
    ns = torch.zeros((n_steps.shape[0], 3), dtype=torch.int64,
                     device=trace.device)
    return _launch(trace, n_steps, num_rows, n_lane, ns), ns


def _launch(trace, n_steps, num_rows: int, n_lane: int, phase_ns):
    """The two launches (csrc/model_pass.cu: the row chains and the steps,
    then the weight chains), each counted."""
    global LAUNCHES
    dev = trace.device
    if dev.type != "cuda":
        raise ValueError(f"model_pass runs on cuda or cpu, not {dev}")
    if num_rows > MAX_ROWS:
        raise ValueError(f"{num_rows} rows: the kernel takes at most "
                         f"{MAX_ROWS}")
    b = n_steps.shape[0]
    t = trace.shape[0]
    check = cuda_build.check
    check("trace", trace, torch.int32, (t, NCOLS), dev)
    check("n_steps", n_steps, torch.int32, (b,), dev)
    lib = build()
    starts = torch.zeros((2 * b, n_lane), dtype=torch.int32, device=dev)
    freqs = torch.ones((2 * b, n_lane), dtype=torch.int32, device=dev)
    counts = torch.zeros((2 * b,), dtype=torch.int32, device=dev)
    if b == 0:
        return starts, freqs, counts
    offsets = torch.cumsum(n_steps.to(torch.int64), 0) - n_steps
    scratch = None
    if not model_in_shared(num_rows):
        scratch = torch.empty((b, num_rows, 16), dtype=torch.int16,
                              device=dev)
    # work space: each step's record of the entries its coding reads, the
    # mixing steps' inputs to the weight chains, each mixer's count
    recs = torch.empty((max(t, 1), 6), dtype=torch.int16, device=dev)
    elem_a = torch.empty((max(t, 1), 4), dtype=torch.int32, device=dev)
    elem_b = torch.empty((max(t, 1), 4), dtype=torch.int32, device=dev)
    elem_info = torch.empty((max(t, 1),), dtype=torch.int32, device=dev)
    mix_counts = torch.empty((2 * b,), dtype=torch.int32, device=dev)
    with cuda_build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dtpu_model_pass(
            trace.data_ptr(), offsets.data_ptr(), n_steps.data_ptr(), b,
            num_rows, n_lane, starts.data_ptr(), freqs.data_ptr(),
            counts.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            recs.data_ptr(), elem_a.data_ptr(), elem_b.data_ptr(),
            elem_info.data_ptr(), mix_counts.data_ptr(),
            div_table(dev).data_ptr(),
            None if phase_ns is None else phase_ns.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"model_pass launch failed: CUDA error {rc}")
    LAUNCHES += 2
    return starts, freqs, counts


def padded(trace, n_steps):
    """The flat trace as [B, N, 10], N the longest frame, each frame's
    tail padding steps (stream -1, lims NOOP_LIM: no row changes, no
    output), as the reference pads it (jax_engine._pad_traces)."""
    b = n_steps.shape[0]
    dev = trace.device
    n = int(n_steps.max()) if b else 0
    out = torch.zeros((b, n, NCOLS), dtype=torch.int32, device=dev)
    out[:, :, 2] = -1
    out[:, :, 4] = NOOP_LIM
    out[:, :, 9] = NOOP_LIM
    t = torch.arange(n, device=dev)[None, :]
    live = t < n_steps[:, None]
    offsets = torch.cumsum(n_steps.to(torch.int64), 0) - n_steps
    out[live] = trace[(offsets[:, None] + t)[live]]
    return out


@torch.inference_mode()
def model_pass_reference_layout(trace, num_rows: int):
    """The reference's own output: (starts, freqs) int32 [B, N] of every
    step of trace int32 [B, N, 10], padding steps included (what
    jax_engine.model_pass returns)."""
    b, n = trace.shape[:2]
    dev = trace.device
    i32 = dict(dtype=torch.int32, device=dev)
    model = cdf16.cdf_init((b, num_rows), device=dev).clone()
    weights = torch.tensor([1, 1, NORM_WEIGHT_INIT], **i32).repeat(b, 2, 1)
    bidx = torch.arange(b, device=dev)
    starts = torch.empty((b, n), **i32)
    freqs = torch.empty((b, n), **i32)
    for k in range(n):
        flat, value, _stream, inc, lim, mix, which, cm_idx, cm_inc, cm_lim = \
            trace[:, k].unbind(1)
        rows = model[bidx, flat]
        cm_rows = model[bidx, cm_idx]
        wsel = weights[bidx, which]
        mixed = cdf16.average(cm_rows, rows, wsel[:, 2] & 0xFFFF)
        do_mix = mix != 0
        coded = torch.where(do_mix[:, None], mixed, rows)
        # (start, freq) of the value under the coded, cm and nibble rows
        start, freq = cdf16.sym_to_start_freq_xla(
            torch.cat([coded, cm_rows, rows]), value.repeat(3))
        freq, p_cm, p_nib = freq.view(3, b)
        new_w = torch.stack(update(wsel[:, 0], wsel[:, 1], p_cm, p_nib, freq),
                            -1)
        weights[bidx, which] = torch.where(do_mix[:, None], new_w, wsel)
        # both rows blended from the rows read before the step, written
        # nibble row first
        rows2, cm2 = cdf16.blend(torch.cat([rows, cm_rows]), value.repeat(2),
                                 torch.cat([inc, cm_inc]),
                                 torch.cat([lim, cm_lim])).view(2, b, 16)
        model[bidx, flat] = rows2
        model[bidx, cm_idx] = cm2
        starts[:, k] = start[:b]
        freqs[:, k] = freq
    return starts, freqs


@torch.inference_mode()
def model_pass_plain(trace, n_steps, num_rows: int, n_lane: int):
    """The same function as `model_pass` in plain PyTorch: the frames in
    lockstep (padded as the reference pads them), then each step's
    (start, freq) scattered to its stream's lane."""
    b = n_steps.shape[0]
    dev = trace.device
    starts = torch.zeros((2 * b, n_lane), dtype=torch.int32, device=dev)
    freqs = torch.ones((2 * b, n_lane), dtype=torch.int32, device=dev)
    if b == 0:
        return starts, freqs, torch.zeros((0,), dtype=torch.int32,
                                          device=dev)
    tr = padded(trace, n_steps)
    st, fr = model_pass_reference_layout(tr, num_rows)
    stream = tr[:, :, 2]
    counts = []
    for sid in (0, 1):
        m = stream == sid
        pos = torch.cumsum(m.to(torch.int64), 1) - 1
        lane = (2 * torch.arange(b, device=dev) + sid)[:, None].expand_as(m)
        keep = m & (pos < n_lane)
        starts[lane[keep], pos[keep]] = st[keep]
        freqs[lane[keep], pos[keep]] = fr[keep]
        counts.append(m.sum(1, dtype=torch.int32))
    return starts, freqs, torch.stack(counts, 1).reshape(-1)
