"""The deferred cmd-stream model pass of the encode: the CUDA kernel, its
wrapper and its plain PyTorch version, with the packing around them.

`cmd_pass` is the port of the Pallas kernel
divans_tpu/codec/pallas_cmd_pass.py:144 (`_make_kernel`, launched by
`_cmd_pass_call` at :298), itself the bit-exact twin of the XLA pass
divans_tpu/codec/jax_engine.py:321 (`model_pass_deferred_cmd`).  On a
CUDA tensor it launches csrc/cmd_pass.cu (built by cuda_build with nvcc
for sm_90a at first use, bound through ctypes) or raises; on a CPU
tensor it runs `cmd_pass_plain`, the same function as a loop over
chunks with a gather for the row fetch and `scatter_add_` for the
counts.  The kernel source documents the contract.

A lane is one frame's cmd stream coded against a fresh model of R rows
(R = the layout's lit_base).  Inputs (natural layout, lanes first):
  packed   uint16 [B, N]  one step per element (flat | value<<8 |
                          act<<12, `pack_cmd_rows`), zero past the lane;
  inc, lim int32 [B, R]   each lane's per-row speeds
                          (`cmd_speeds_from_rows`);
  n_steps  int32 [B]      the lane's steps (clamped to [0, N]);
  s                       steps per chunk (deferred.cmd_chunk); N is a
                          multiple of it.
Outputs: starts, freqs int32 [B, N]; 0 at and past n_steps.  The TPU
kernel shares one speed table among a launch's lanes; here each lane
brings its own, so lanes from frames checked one by one can share a
launch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build
from ..probability import cdf16
from .deferred import MAX_RENORM_PASSES

NAME = "cmd_pass"
_SIGNATURES = {"dtpu_cmd_pass": [ctypes.c_void_p, ctypes.c_int]
               + [ctypes.c_void_p] * 5
               + [ctypes.c_int] * 3 + [ctypes.c_void_p],
               "dtpu_cmd_pass_smem": []}
MAX_ROWS = 256   # flat is 8 bits
# the kernel's dynamic shared memory (csrc/cmd_pass.cu): two copies of
# the model and two count histograms of 256 rows of 20 ints (16 and the
# padding), the row speeds and four 256-bit row masks
SHARED_BYTES = 4 * (4 * MAX_ROWS * 20 + 2 * MAX_ROWS + 4 * MAX_ROWS // 32)

# kernel launches, counted where the wrapper launches (and nowhere else)
LAUNCHES = 0


def build():
    """csrc/cmd_pass.cu, compiled for sm_90a at first use, loaded."""
    return cuda_build.load(NAME, _SIGNATURES)


def cmd_speeds_from_rows(cmd_ts: list[np.ndarray], num_rows: int):
    """Per-row (inc, lim) int32[num_rows] of cmd traces, checked constant
    (the FSM codes each cmd row at one fixed speed), or None when a row
    is seen with two speeds or a step mixes."""
    inc_row = np.zeros(num_rows, np.int64)
    lim_row = np.zeros(num_rows, np.int64)
    for t in cmd_ts:
        if t.shape[0] == 0:
            continue
        if (t[:, 5] != 0).any():
            return None
        live = t[t[:, 3] != 0]
        rows, inc, lim = live[:, 0], live[:, 3], live[:, 4]
        seen = inc_row[rows] != 0
        if ((inc_row[rows] != inc) & seen).any() \
                or ((lim_row[rows] != lim) & seen).any():
            return None
        inc_row[rows] = inc
        lim_row[rows] = lim
    return inc_row.astype(np.int32), lim_row.astype(np.int32)


def pack_cmd_rows(t: np.ndarray) -> np.ndarray:
    """A cmd trace [n, 10] as uint16[n] steps: flat | value<<8 | act<<12,
    act = inc != 0 (the row of pallas_cmd_pass.pack_cmd_traces)."""
    if t.shape[0] and (t[:, 0].max() >= MAX_ROWS or t[:, 0].min() < 0):
        raise ValueError(f"a cmd row outside [0, {MAX_ROWS})")
    act = (t[:, 3] != 0).astype(np.int32)
    return (t[:, 0] | (t[:, 1] << 8) | (act << 12)).astype(np.uint16)


def assemble_cmd_rows(rows: list[np.ndarray], n_padded: int) -> np.ndarray:
    """Per-lane packed steps -> uint16 [B, n_padded], zero padded."""
    packed = np.zeros((len(rows), n_padded), np.uint16)
    for i, row in enumerate(rows):
        packed[i, :row.shape[0]] = row
    return packed


def from_tpu_cmd_planes(packed) -> np.ndarray:
    """The TPU kernel's packed input [NG, C, S, G] (lane G*g + l at
    [g, :, :, l]) as the port's [NG*G, C*S] uint16."""
    packed = np.asarray(packed)
    ng, c, s, g = packed.shape
    return np.ascontiguousarray(packed.transpose(0, 3, 1, 2)).reshape(
        ng * g, c * s).astype(np.uint16)


def cmd_pass(packed, inc, lim, n_steps, s: int):
    """(starts, freqs) int32 [B, N] of every lane's cmd steps."""
    global LAUNCHES
    dev = packed.device
    if dev.type == "cpu":
        return cmd_pass_plain(packed, inc, lim, n_steps, s)
    if dev.type != "cuda":
        raise ValueError(f"cmd_pass runs on cuda or cpu, not {dev}")
    b, n = packed.shape
    r = inc.shape[-1]
    check = cuda_build.check
    check("packed", packed, torch.uint16, (b, n), dev)
    check("inc", inc, torch.int32, (b, r), dev)
    check("lim", lim, torch.int32, (b, r), dev)
    check("n_steps", n_steps, torch.int32, (b,), dev)
    if s & (s - 1) or not 16 <= s <= 256 or n % s:
        raise ValueError(f"s {s} must be a power of two in [16, 256] "
                         f"dividing N = {n}")
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"{r} rows: the kernel takes 1 to {MAX_ROWS}")
    lib = build()
    starts = torch.empty((b, n), dtype=torch.int32, device=dev)
    freqs = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return starts, freqs
    with cuda_build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dtpu_cmd_pass(packed.data_ptr(), n, inc.data_ptr(),
                               lim.data_ptr(), n_steps.data_ptr(),
                               starts.data_ptr(), freqs.data_ptr(), b, r, s,
                               stream)
    if rc != 0:
        raise RuntimeError(f"cmd_pass launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return starts, freqs


@torch.inference_mode()
def cmd_pass_plain(packed, inc, lim, n_steps, s: int):
    """The same function in plain PyTorch: per chunk, a gather of every
    active step's row from the frozen snapshot and (start, freq) for all
    lanes and steps at once, then the count histogram (`scatter_add_`)
    and the lagged commit with its renorm passes."""
    b, n = packed.shape
    r = inc.shape[-1]
    dev = packed.device
    i32 = dict(dtype=torch.int32, device=dev)
    p = packed.to(torch.int32)
    n_steps = torch.clamp(n_steps, 0, n)
    committed = cdf16.cdf_init((b, r), dev)
    pend_add = torch.zeros((b, r, 16), **i32)
    pend_lim = torch.full((b, r), 0x8000, **i32)
    init = cdf16.cdf_init((), dev)
    bias = torch.arange(1, 17, **i32)
    lanes = torch.arange(b, device=dev)[:, None]
    step_iota = torch.arange(s, **i32)
    starts = torch.zeros((b, n), **i32)
    freqs = torch.zeros((b, n), **i32)
    n_chunks = -(-int(n_steps.max()) // s) if b else 0
    for c in range(n_chunks):
        q = p[:, c * s:(c + 1) * s]
        keep = c * s + step_iota[None, :] < n_steps[:, None]
        act = (((q >> 12) & 1) != 0) & keep
        flat = torch.where(act, q & 0xFF, 0).long()
        val = (q >> 8) & 15

        # ---- fetch from the frozen snapshot (commits through chunk c-2)
        rows = torch.where(act[..., None], committed[lanes, flat], init)
        st, fr = cdf16.sym_to_start_freq(rows, val)
        starts[:, c * s:(c + 1) * s] = torch.where(keep, st, 0)
        freqs[:, c * s:(c + 1) * s] = torch.where(keep, fr, 0)

        # ---- this chunk's pend; commit the previous chunk's (lag 1)
        cnt = torch.zeros((b, r * 16), **i32)
        cnt.scatter_add_(1, flat * 16 + val.long(), act.to(torch.int32))
        cum = torch.cumsum(cnt.view(b, r, 16), dim=2, dtype=torch.int32)
        new_add = inc[:, :, None] * cum
        new_lim = torch.where(cum[:, :, 15] > 0, lim, 0x8000)
        committed = committed + pend_add
        for _ in range(MAX_RENORM_PASSES):
            over = committed[:, :, 15] >= pend_lim
            if not bool(over.any()):
                break
            cb = committed + bias
            committed = torch.where(over[..., None], cb - (cb >> 2),
                                    committed)
        pend_add, pend_lim = new_add, new_lim
    return starts, freqs
