"""The deferred literal model pass of the encode: the CUDA kernel, its
wrapper and its plain PyTorch version.

`lit_pass` is the port of the Pallas kernel
divans_tpu/codec/pallas_lit_pass.py:99 (`_make_kernel`, launched by
`_lit_pass_call` at :357), itself the bit-exact twin of the XLA pass
divans_tpu/codec/jax_engine.py:387 (`model_pass_deferred_lit`).  On a
CUDA tensor it launches csrc/lit_pass.cu (built by cuda_build with nvcc
for sm_90a at first use, bound through ctypes) or raises; on a CPU
tensor it runs `lit_pass_plain`, the same function as a loop over
chunks with vector ops over lanes and bytes, on the literal model of
codec/lit_model.py.  The kernel source documents the contract.

A lane is one literal sub-stream (at most SUB_LIT bytes) coded against
a fresh model.  Inputs (natural layout, lanes first):
  rows   uint16 [B, N/2]  one packed literal byte per element
                          (ctx | hi<<6 | lo<<10 | act<<14 | mix<<15,
                          native.pack_lit's row), zero past the lane;
  spd    int32 [B, 6]     (inc, lim) of speeds 0, 2, 3 per lane;
  n_nib  int32 [B]        the lane's nibbles (2 per byte);
  chunk                   nibbles per chunk; N is a multiple of it.
Outputs: starts, freqs int32 [B, N]: nibble 2t is byte t's hi nibble,
2t+1 its lo nibble; 0 at and past n_nib.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build
from ..probability import cdf16
from ..probability.weights import bit_length_pos
from . import lit_model
from .deferred import ADJ_CLAMP
from .layout import ModelLayout, PROFILES

NAME = "lit_pass"
_SIGNATURES = {"dtpu_lit_pass": [ctypes.c_void_p, ctypes.c_int]
               + [ctypes.c_void_p] * 4
               + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
               "dtpu_lit_pass_smem": [],
               "dtpu_lit_pass_threads": [ctypes.c_int]}
# the kernel's dynamic shared memory (csrc/lit_pass.cu), one size for
# every chunk: two copies of the model (384 rows) and two count
# histograms (192 rows) of 20 ints (16 and the padding), four 384-bit
# row masks, two copies of the weights, two chunks' adjustments (four
# sums for each of up to 8 coder warps) and a pair of CDF_INIT rows
SHARED_BYTES = 4 * (2 * 384 * 20 + 2 * 192 * 20 + 4 * 384 // 32 + 16
                    + 2 * 8 * 4 + 2 * 20)


def threads(chunk: int) -> int:
    """The kernel's threads a block at `chunk` (csrc/lit_pass.cu's
    dtpu_lit_pass_threads): 384 committers, a warp for the two weight
    threads, and a coder a nibble up to 256 (at least one warp)."""
    return 384 + 32 + min(max(chunk, 32), 256)


# kernel launches, counted where the wrapper launches (and nowhere else)
LAUNCHES = 0


def build():
    """csrc/lit_pass.cu, compiled for sm_90a at first use, loaded."""
    return cuda_build.load(NAME, _SIGNATURES)


def assemble_lit_rows(rows, spds, n_padded: int):
    """Per-lane packed rows (uint16 [n_bytes_i]) and speeds ([6] each) ->
    (packed uint16 [B, n_padded/2], spd int32 [B, 6]): the counterpart
    of pallas_lit_pass.assemble_lit_planes in the port's layout."""
    b = len(rows)
    packed = np.zeros((b, n_padded // 2), np.uint16)
    spd = np.zeros((b, 6), np.int32)
    for i, (row, sp) in enumerate(zip(rows, spds)):
        packed[i, :row.shape[0]] = row
        spd[i] = sp
    return packed, spd


def pack_lit_row(t: np.ndarray):
    """One frame's rebased lit trace [T, 10] -> (packed row uint16[T/2],
    spd int32[6]), or None when the trace leaves the packed-byte envelope
    (an odd step count, a hi/lo pair that disagrees on activity or
    mixing, rows off the bucketed cm pattern, a dead first step).  The
    numpy twin of native.pack_lit (its rows, its speeds, its refusals),
    which the encode takes without the library; the port of the
    reference's pallas_lit_pass.pack_lit_row."""
    n = t.shape[0]
    if n % 2:
        return None
    spd = np.zeros(6, np.int32)
    if n == 0:
        return np.zeros(0, np.uint16), spd
    flat = t[:, 0]
    hi_f = flat[0::2]
    hi_v, lo_v = t[0::2, 1], t[1::2, 1]
    act = ((t[:, 3] != 0) | (t[:, 5] != 0)).astype(np.int32)
    act_h, act_l = act[0::2], act[1::2]
    mix_h, mix_l = t[0::2, 5], t[1::2, 5]
    if (act_h != act_l).any() or (mix_h != mix_l).any():
        return None
    ctx = np.where(act_h != 0, hi_f - 1, 0)
    if ((ctx < 0) | (ctx >= 64)).any():
        return None
    idx_expect = 65 + (ctx >> 3) * 16 + hi_v
    if (np.where(act_l != 0, flat[1::2], idx_expect) != idx_expect).any():
        return None
    # mixing steps read the cm rows of the bucketed cm layout
    exp_h = 193 + ctx
    exp_l = 257 + hi_v * 8 + (ctx >> 3)
    if (np.where(mix_h != 0, t[0::2, 7], exp_h) != exp_h).any():
        return None
    if (np.where(mix_l != 0, t[1::2, 7], exp_l) != exp_l).any():
        return None
    if t[0, 3] == 0:
        return None   # the speeds are read from the first byte's steps
    spd[:] = [t[0, 3], t[0, 4], t[1, 8], t[1, 9], t[0, 8], t[0, 9]]
    row = (ctx | (hi_v << 6) | (lo_v << 10) | (act_h << 14) | (mix_h << 15))
    return row.astype(np.uint16), spd


def from_tpu_lit_planes(packed, spd_pl):
    """The TPU kernel's inputs (packed [NG, C, S, G] with lane G*g + l at
    [g, :, :, l], spd planes [NG, 8, 128] with lane l's scalar r over
    columns 16l..16l+15 of row r) as the port's (packed [NG*G, C*S],
    spd [NG*G, 6])."""
    packed = np.asarray(packed)
    ng, c, s, g = packed.shape
    rows = np.ascontiguousarray(packed.transpose(0, 3, 1, 2)).reshape(
        ng * g, c * s)
    spd = np.asarray(spd_pl)[:, :6, ::16]                  # [NG, 6, G]
    return rows, np.ascontiguousarray(spd.transpose(0, 2, 1)).reshape(
        ng * g, 6).astype(np.int32)


def lit_pass(rows, spd, n_nib, chunk: int):
    """(starts, freqs) int32 [B, N] of every lane's literal nibbles: on
    CUDA one block of threads(chunk) threads and SHARED_BYTES of shared
    memory a lane."""
    global LAUNCHES
    dev = rows.device
    if dev.type == "cpu":
        return lit_pass_plain(rows, spd, n_nib, chunk)
    if dev.type != "cuda":
        raise ValueError(f"lit_pass runs on cuda or cpu, not {dev}")
    b, half = rows.shape
    check = cuda_build.check
    check("rows", rows, torch.uint16, (b, half), dev)
    check("spd", spd, torch.int32, (b, 6), dev)
    check("n_nib", n_nib, torch.int32, (b,), dev)
    if chunk & (chunk - 1) or not 16 <= chunk <= 1024 or (2 * half) % chunk:
        raise ValueError(f"chunk {chunk} must be a power of two in "
                         f"[16, 1024] dividing N = {2 * half}")
    lib = build()
    starts = torch.empty((b, 2 * half), dtype=torch.int32, device=dev)
    freqs = torch.empty((b, 2 * half), dtype=torch.int32, device=dev)
    if b == 0 or half == 0:
        return starts, freqs
    with cuda_build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dtpu_lit_pass(rows.data_ptr(), half, spd.data_ptr(),
                               n_nib.data_ptr(), starts.data_ptr(),
                               freqs.data_ptr(), b, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"lit_pass launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return starts, freqs


def mixer_adjustments(freq, p_cm, p_nib, mix):
    """Per-lane sums of the mixer adjustments over a chunk's steps where
    `mix` is set (the reference's deferred.weight_adjustments), with
    int32 wraparound: int32 [B, 2] = (cm, nib)."""
    error = (1 << 15) - freq
    shift = torch.clamp(bit_length_pos(freq * error) - 15, min=0)
    return torch.stack(
        [torch.sum(torch.where(mix, torch.clamp(
            (error * (p - freq)) >> shift, -ADJ_CLAMP, ADJ_CLAMP), 0),
            dim=1, dtype=torch.int32) for p in (p_cm, p_nib)], dim=-1)


@torch.inference_mode()
def lit_pass_plain(rows, spd, n_nib, chunk: int):
    """The same function in plain PyTorch: per chunk, gathers from the
    frozen snapshot, the mixer and (start, freq) for all lanes and bytes
    at once, then the shared histograms and lagged commit."""
    b, half = rows.shape
    n = 2 * half
    s = chunk // 2
    dev = rows.device
    i32 = dict(dtype=torch.int32, device=dev)
    packed = rows.to(torch.int32)
    n_byte = (n_nib // 2)[:, None]
    perm = torch.from_numpy(lit_model.planes(
        ModelLayout(PROFILES["cm"], lo_bucketed=True))).long().to(dev)
    perm2 = lit_model.perm_cm2(dev)
    n_pass = lit_model.renorm_passes(spd.cpu().numpy(), s)
    committed, weights, pend = lit_model.init_state(b, dev)
    init = cdf16.cdf_init((), dev)
    lanes = torch.arange(b, device=dev)[:, None]
    byte_iota = torch.arange(s, **i32)
    nib_iota = torch.arange(chunk, **i32)
    starts = torch.zeros((b, n), **i32)
    freqs = torch.zeros((b, n), **i32)
    n_chunks = -(-int(n_nib.max()) // chunk) if b else 0
    for c in range(n_chunks):
        p = packed[:, c * s:(c + 1) * s]
        ctx = (p & 63).long()
        hi = ((p >> 6) & 15).long()
        lo = ((p >> 10) & 15).long()
        act = (((p >> 14) & 1) != 0) & (c * s + byte_iota < n_byte)
        mix = (((p >> 15) & 1) != 0) & act
        idx = (ctx >> 3) * 16 + hi

        # ---- fetch from the frozen snapshot (commits through chunk c-2)
        g = committed[:, perm]                            # [B, 384, 16]
        live = act[..., None]
        nw = weights[:, :, 2] & 0xFFFF                    # [B, which]
        out, adj = [], []
        # kernel-order planes: lit_hi, cm_first by ctx at 0 and 64;
        # lit_lo, cm_second by (ctx>>3)*16 + hi at 128 and 256
        for nib_p, cm_p, sym, nw_w in ((ctx, 64 + ctx, hi, nw[:, 1:2]),
                                       (128 + idx, 256 + idx, lo,
                                        nw[:, 0:1])):
            nib = torch.where(live, g[lanes, nib_p], init)
            cm = torch.where(live, g[lanes, cm_p], init)
            coded = torch.where(mix[..., None],
                                cdf16.average(cm, nib, nw_w), nib)
            start, freq = cdf16.sym_to_start_freq(coded, sym)
            p_cm = cdf16.sym_to_start_freq(cm, sym)[1]
            p_nib = cdf16.sym_to_start_freq(nib, sym)[1]
            out.append((start, freq))
            adj.append(mixer_adjustments(freq, p_cm, p_nib, mix))
        wadj = torch.stack([adj[1], adj[0]], dim=1)       # [B, which, 2]

        # ---- outputs, hi and lo nibbles interleaved
        keep = c * chunk + nib_iota[None, :] < n_nib[:, None]
        for dst, k in ((starts, 0), (freqs, 1)):
            v = torch.stack([out[0][k], out[1][k]], dim=-1).reshape(b, chunk)
            dst[:, c * chunk:(c + 1) * chunk] = torch.where(keep, v, 0)

        # ---- this chunk's pend; commit the previous chunk's (lag 1)
        cnt_hi, cnt_lo = lit_model.count_hists(ctx, hi, lo, act)
        new_pend = lit_model.chunk_pend(cnt_hi, cnt_lo, spd, wadj, perm2)
        committed, weights = lit_model.apply_pend(committed, weights, pend,
                                                  n_pass)
        pend = new_pend
    return starts, freqs
