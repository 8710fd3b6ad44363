"""The generic deferred model pass of the encode: the CUDA kernel, its
wrapper and its plain PyTorch version, with the trace padding around
them.

`deferred_pass` is the port of the Pallas kernel
divans_tpu/codec/pallas_model.py:100 (`_kernel`, launched by
`model_pass_deferred_pallas` at :301), itself the bit-exact twin of the
XLA pass divans_tpu/codec/jax_engine.py:209 (`model_pass_deferred`) and
of the normative replay divans_tpu/codec/deferred.py (`replay_trace`).
It codes every stream the specialised passes do not take: the stride
and mix profiles' literals, and a cmd stream whose speeds are not
constant per row.  On a CUDA tensor it launches csrc/deferred_pass.cu
(built by cuda_build with nvcc for sm_90a at first use, bound through
ctypes) or raises; on a CPU tensor it runs `deferred_pass_plain`, the
same function as a loop over chunks: a gather from the frozen snapshot
for the row fetch, `index_add_` for the chunk's per-row pend, and a
commit of the rows the previous chunk touched.  The kernel source
documents the contract.  Both raise on a live step out of range before
they read it: check_trace, which on the card waits for it, unless the
caller has checked each lane on the host with check_lane (the encode
does, in its host pool) and says so with `checked=True`.

A lane is one stream (a frame's cmd stream, or one literal sub-stream
rebased to the literal sub-model) coded against a fresh model of R rows
and fresh mixer weights.  Inputs (natural layout, lanes first):
  trace   int32 [B, N, 10]  the reference's trace columns (flat, value,
                            stream, inc, lim, mix, which, cm_idx,
                            cm_inc, cm_lim), `pad_traces`'s padding
                            past each lane;
  counts  int32 [B]         the lane's steps (clamped to [0, N]);
  num_rows                  R; every live step's flat and cm_idx lie in
                            [0, R), its value in [0, 16), which in {0, 1};
  chunk                     steps per chunk; N is a multiple of it.
Outputs: starts, freqs int32 [B, N]; 0 at and past the lane's count.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build
from ..probability import cdf16
from ..probability.weights import (NORM_WEIGHT_INIT, WEIGHT_MAX,
                                   fix_weights, floor_div, norm_weight)
from .deferred import MAX_RENORM_PASSES
from .lit_pass import mixer_adjustments

NAME = "deferred_pass"
_SIGNATURES = {"dtpu_deferred_pass": [ctypes.c_void_p, ctypes.c_int]
               + [ctypes.c_void_p] * 4
               + [ctypes.c_int] * 3 + [ctypes.c_void_p],
               "dtpu_deferred_pass_smem": [ctypes.c_int]}
NCOLS = 10          # trace columns (divans_tpu/codec/trace.py)
NOOP_LIM = 0x4000   # a padding step's lim: blend(row, v, 0, 0x4000) is a no-op
SCRATCH_INTS = 16   # per lane and row: the model (the pend stays on chip)
SMEM_MAX = 232448   # a block's shared memory on sm_90
_SMEM_STATIC = 256  # reserved for the kernel's static shared words

# kernel launches, counted where the wrapper launches (and nowhere else)
LAUNCHES = 0


def build():
    """csrc/deferred_pass.cu, compiled for sm_90a at first use, loaded."""
    return cuda_build.load(NAME, _SIGNATURES)


def fold_rows(s: int) -> int:
    """Touched rows the kernel folds and commits at once at chunk s: all
    of a chunk's (2s) where they fit in shared memory beside its 168 s
    bytes of staged trace, records, touched lists and hash, else as many
    as fit at 168 B a row, a multiple of 16 (csrc/deferred_pass.cu)."""
    fit = (SMEM_MAX - _SMEM_STATIC - 168 * s) // 168 & ~15
    return min(2 * s, fit)


def shared_bytes(s: int) -> int:
    """The dynamic shared memory of a launch at chunk s (bytes)."""
    return 168 * s + 168 * fold_rows(s)


def pad_traces(traces: list[np.ndarray], multiple: int) -> np.ndarray:
    """Lane traces [n_i, 10] -> int32 [B, N, 10], N the longest lane
    rounded up to a whole chunk (at least one), padded as
    jax_engine._pad_traces pads: lim and cm_lim NOOP_LIM, stream -1,
    every other column 0."""
    longest = max((t.shape[0] for t in traces), default=0)
    n = max(multiple, -(-longest // multiple) * multiple)
    out = np.zeros((len(traces), n, NCOLS), np.int32)
    out[:, :, 9] = NOOP_LIM
    out[:, :, 4] = NOOP_LIM
    out[:, :, 2] = -1
    for i, t in enumerate(traces):
        out[i, :t.shape[0]] = t
    return out


_RANGE_ERROR = ("a step's flat or cm_idx outside [0, {}), its value outside "
                "[0, 16) or its which outside {{0, 1}}")


def check_lane(trace: np.ndarray, num_rows: int) -> None:
    """Raise unless every step of one lane's trace int32 [n, 10] has its
    rows, symbol and mixer in range: check_trace on the host, before the
    lane is padded and uploaded (no device sync)."""
    cols = trace[:, [0, 7, 1, 6]]
    if ((cols < 0) | (cols >= np.array([num_rows, num_rows, 16, 2]))).any():
        raise ValueError(_RANGE_ERROR.format(num_rows))


def check_trace(trace, counts, num_rows: int) -> None:
    """Raise unless every live step's rows, symbol and mixer lie in
    range (the kernel reads nothing else).  On a CUDA tensor this waits
    for the card."""
    n = trace.shape[1]
    live = (torch.arange(n, device=trace.device)[None, :]
            < counts[:, None])[..., None]
    lo = torch.tensor([0, 0, 0, 0], device=trace.device)
    hi = torch.tensor([num_rows, num_rows, 16, 2], device=trace.device)
    cols = trace[:, :, [0, 7, 1, 6]]
    if bool((((cols < lo) | (cols >= hi)) & live).any()):
        raise ValueError(_RANGE_ERROR.format(num_rows))


def deferred_pass(trace, counts, num_rows: int, chunk: int,
                  checked: bool = False):
    """(starts, freqs) int32 [B, N] of every lane's trace steps.
    `checked`: every live step already passed check_lane on the host, so
    a launch skips check_trace and the device sync it costs."""
    global LAUNCHES
    dev = trace.device
    if dev.type == "cpu":
        return deferred_pass_plain(trace, counts, num_rows, chunk)
    if dev.type != "cuda":
        raise ValueError(f"deferred_pass runs on cuda or cpu, not {dev}")
    b, n = trace.shape[:2]
    check = cuda_build.check
    check("trace", trace, torch.int32, (b, n, NCOLS), dev)
    check("counts", counts, torch.int32, (b,), dev)
    if chunk & (chunk - 1) or not 16 <= chunk <= 1024 or n % chunk:
        raise ValueError(f"chunk {chunk} must be a power of two in "
                         f"[16, 1024] dividing N = {n}")
    if num_rows < 1:
        raise ValueError(f"{num_rows} rows: the model needs at least one")
    if not checked:
        check_trace(trace, torch.clamp(counts, 0, n), num_rows)
    lib = build()
    starts = torch.empty((b, n), dtype=torch.int32, device=dev)
    freqs = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return starts, freqs
    scratch = torch.empty((b, SCRATCH_INTS * num_rows), dtype=torch.int32,
                          device=dev)
    with cuda_build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dtpu_deferred_pass(trace.data_ptr(), n, counts.data_ptr(),
                                    scratch.data_ptr(), starts.data_ptr(),
                                    freqs.data_ptr(), b, num_rows, chunk,
                                    stream)
    if rc != 0:
        raise RuntimeError(f"deferred_pass launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return starts, freqs


def _commit(committed, weights, pend):
    """The boundary rules of one lagged chunk (codec/deferred.py), in
    place on committed [B*R, 16]: each row the chunk touched takes its
    added counts, then renorm passes while its row[15] >= lim_eff =
    limsum // hits (at most MAX_RENORM_PASSES); untouched rows stay as
    they are.  Returns the new weights [B, 2, 3]."""
    keys, add, limsum, cnt, wadj = pend
    rows = committed[keys] + add
    lim_eff = floor_div(limsum, cnt)
    bias = torch.arange(1, 17, dtype=torch.int32, device=rows.device)
    for _ in range(MAX_RENORM_PASSES):
        over = rows[:, 15] >= lim_eff
        if not bool(over.any()):
            break
        cb = rows + bias
        rows = torch.where(over[:, None], cb - (cb >> 2), rows)
    committed[keys] = rows
    w01 = torch.clamp(weights[..., :2] + wadj, 1, WEIGHT_MAX)
    w0, w1 = fix_weights(w01[..., 0], w01[..., 1])
    return torch.stack([w0, w1, norm_weight(w0, w1)], dim=-1)


@torch.inference_mode()
def deferred_pass_plain(trace, counts, num_rows: int, chunk: int):
    """The same function in plain PyTorch: per chunk, the rows of every
    live step gathered from the frozen snapshot, the mixer and (start,
    freq) for all lanes and steps at once; then the chunk's pend over
    the rows it touched and the commit of the previous chunk's (lag 1).
    The model is [B*R, 16], lane-major, so a (lane, row) pair is one
    key."""
    b, n = trace.shape[:2]
    r = num_rows
    dev = trace.device
    i32 = dict(dtype=torch.int32, device=dev)
    counts = torch.clamp(counts, 0, n)
    check_trace(trace, counts, r)
    committed = cdf16.cdf_init((b * r,), dev)
    weights = torch.cat([torch.ones((b, 2, 2), **i32),
                         torch.full((b, 2, 1), NORM_WEIGHT_INIT, **i32)],
                        dim=2)
    base = torch.arange(b, device=dev)[:, None] * r
    step_iota = torch.arange(chunk, **i32)
    starts = torch.zeros((b, n), **i32)
    freqs = torch.zeros((b, n), **i32)
    pend = None
    n_chunks = -(-int(counts.max()) // chunk) if b else 0
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        keep = c * chunk + step_iota[None, :] < counts[:, None]
        q = torch.where(keep[..., None], trace[:, sl], 0)
        (flat, value, _stream, inc, lim, mix, which, cm_idx, cm_inc,
         cm_lim) = q.unbind(-1)
        key = base + flat
        cm_key = base + cm_idx

        # ---- code the chunk against the frozen snapshot
        rows = committed[key]
        cm_rows = committed[cm_key]
        do_mix = mix != 0
        nw = torch.gather(weights[:, :, 2], 1, which.long()) & 0xFFFF
        coded = torch.where(do_mix[..., None],
                            cdf16.average(cm_rows, rows, nw), rows)
        start, freq = cdf16.sym_to_start_freq(coded, value)
        starts[:, sl] = start * keep
        freqs[:, sl] = freq * keep
        p_cm = cdf16.sym_to_start_freq(cm_rows, value)[1]
        p_nib = cdf16.sym_to_start_freq(rows, value)[1]
        wadj = torch.stack([mixer_adjustments(freq, p_cm, p_nib,
                                              do_mix & (which == w))
                            for w in (0, 1)], dim=1)        # [B, which, 2]

        # ---- the chunk's pend over the rows it touched
        hit = inc != 0
        cm_hit = do_mix & (cm_inc != 0)
        keys = torch.cat([key[hit], cm_key[cm_hit]])
        sym = torch.cat([value[hit], value[cm_hit]]).long()
        uniq, inv = torch.unique(keys, return_inverse=True)
        u = uniq.shape[0]
        add = torch.zeros(u * 16, **i32).index_add_(
            0, inv * 16 + sym, torch.cat([inc[hit], cm_inc[cm_hit]]))
        limsum = torch.zeros(u, **i32).index_add_(
            0, inv, torch.cat([lim[hit], cm_lim[cm_hit]]))
        cnt = torch.zeros(u, **i32).index_add_(
            0, inv, torch.ones(keys.shape[0], **i32))
        new_pend = (uniq, torch.cumsum(add.view(u, 16), 1, dtype=torch.int32),
                    limsum, cnt, wadj)

        # ---- commit the previous chunk's (lag 1)
        if pend is not None:
            weights = _commit(committed, weights, pend)
        pend = new_pend
    return starts, freqs
