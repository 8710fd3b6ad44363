"""Wide rANS encode of the encode's literal lanes: the CUDA kernel, its
wrapper and its plain PyTorch version, with the compaction and the wire
assembly around them.

`encode_lanes` is the port of the Pallas kernel
divans_tpu/ans/pallas_kernels.py:57 (`_encode_kernel`, launched by
`encode_lanes_pallas` at :88).  On a CUDA tensor it launches
csrc/rans_encode.cu (built by cuda_build with nvcc for sm_90a at first
use, bound through ctypes) or raises; on a CPU tensor it runs
`encode_lanes_plain`, a loop over the symbols, backward, with vector
ops over the lanes.  Wire semantics are rans32 (ans/coder_np.py).

Layout (natural, lanes first): starts, freqs int32 [B, N] (symbol t of
lane b at [b, t]; columns at and past counts[b] are padding), counts
int32 [B] -> words int16 [B, N] (state & 0xFFFF before symbol t),
flags int8 [B, N] (a word was emitted at t), states int32 [B].
`compact_global` (XLA in the reference, plain torch here) and
`assemble_global` (numpy on the host) turn those into per-lane bytes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build
from ..constants import LOG2_SCALE
from ..probability.weights import floor_div
from .coder_np import ENC_START_STATE, RENORM_BITS

NAME = "rans_encode"
_SIGNATURES = {"dtpu_rans_encode": [ctypes.c_void_p] * 6
               + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}

# kernel launches, counted where the wrapper launches (and nowhere else)
LAUNCHES = 0


def build():
    """csrc/rans_encode.cu, compiled for sm_90a at first use, loaded."""
    return cuda_build.load(NAME, _SIGNATURES)


def from_tpu_ans_lanes(starts, freqs, counts):
    """The TPU kernel's [N, G, 128] / [G, 128] inputs (lane i at
    divmod(i, 128)) as the port's [G*128, N] / [G*128]."""
    n = np.asarray(starts).shape[0]

    def lanes_first(a):
        return np.ascontiguousarray(np.asarray(a).reshape(n, -1).T)

    return (lanes_first(starts), lanes_first(freqs),
            np.asarray(counts).reshape(-1).copy())


def encode_lanes(starts, freqs, counts):
    """(words, flags, states) of every lane's reverse encode."""
    global LAUNCHES
    dev = starts.device
    if dev.type == "cpu":
        return encode_lanes_plain(starts, freqs, counts)
    if dev.type != "cuda":
        raise ValueError(f"encode_lanes runs on cuda or cpu, not {dev}")
    b, n = starts.shape
    check = cuda_build.check
    check("starts", starts, torch.int32, (b, n), dev)
    check("freqs", freqs, torch.int32, (b, n), dev)
    check("counts", counts, torch.int32, (b,), dev)
    lib = build()
    words = torch.empty((b, n), dtype=torch.int16, device=dev)
    flags = torch.empty((b, n), dtype=torch.int8, device=dev)
    states = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return words, flags, states
    with cuda_build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dtpu_rans_encode(starts.data_ptr(), freqs.data_ptr(),
                                  counts.data_ptr(), words.data_ptr(),
                                  flags.data_ptr(), states.data_ptr(), b, n,
                                  stream)
    if rc != 0:
        raise RuntimeError(f"encode_lanes launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return words, flags, states


@torch.inference_mode()
def encode_lanes_plain(starts, freqs, counts):
    """The same function in plain PyTorch: t from N-1 down to 0, every
    lane at once (int32 throughout, floor division as the reference's
    `//` and `%`)."""
    b, n = starts.shape
    dev = starts.device
    # time-major copies: each step reads contiguous rows
    fr_t = torch.clamp(freqs, min=1).T.contiguous()
    st_t = starts.T.contiguous()
    bound_t = fr_t << RENORM_BITS
    valid_t = torch.arange(n, dtype=torch.int32, device=dev)[:, None] \
        < counts[None, :]
    state = torch.full((b,), ENC_START_STATE, dtype=torch.int32, device=dev)
    # columns past every count never move the start state
    n_max = max(0, int(counts.max())) if b else 0
    before = [state] * n
    flags = [torch.zeros(b, dtype=torch.bool, device=dev)] * n
    for t in range(n_max - 1, -1, -1):
        before[t] = state
        valid = valid_t[t]
        flag = valid & (state >= bound_t[t])
        flags[t] = flag
        x = torch.where(flag, state >> RENORM_BITS, state)
        f = fr_t[t]
        coded = (floor_div(x, f) << LOG2_SCALE) + torch.remainder(x, f) \
            + st_t[t]
        state = torch.where(valid, coded, x)
    if not n:
        return (torch.zeros((b, 0), dtype=torch.int16, device=dev),
                torch.zeros((b, 0), dtype=torch.int8, device=dev), state)
    words = torch.stack(before, dim=1)
    words = (((words & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)
    return words, torch.stack(flags, dim=1).to(torch.int8), state


def compact_global(words, flags, counts, states):
    """All lanes' emitted words in one flat lane-major stream, on the
    tensors' device (the reference's XLA compaction,
    pallas_kernels.compact_global, in plain torch: cumsum plus
    scatter_).  Returns (flat int16 [B*N] holding uint16 bits, lane i's
    words at [sum(nw[:i]), sum(nw[:i+1])) in wire order, i.e. increasing
    t; header int32 [2, B] = stacked (nw, states))."""
    b, n = words.shape
    dev = words.device
    t = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    live = (flags != 0) & (t < counts[:, None])
    live32 = live.to(torch.int32)
    nw = torch.sum(live32, dim=1, dtype=torch.int32)
    lane_off = torch.cumsum(nw, dim=0, dtype=torch.int32) - nw
    pos = torch.cumsum(live32, dim=1, dtype=torch.int32) - 1 \
        + lane_off[:, None]
    pos = torch.where(live, pos, b * n).reshape(-1).long()   # b*n: dropped
    flat = torch.zeros(b * n + 1, dtype=words.dtype, device=dev)
    flat.scatter_(0, pos, words.reshape(-1))
    return flat[:-1], torch.stack([nw, states])


def compact_lanes(words, flags, counts):
    """Each lane's emitted words at the front of its own row, on the
    tensors' device: the reference's per-lane form (ans/kernels.py
    `_encode_lane`).  Returns (int32 [B, N] holding each word's uint16
    value in wire order, zeros past them; nwords int32 [B])."""
    b, n = words.shape
    dev = words.device
    t = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    live = (flags != 0) & (t < counts[:, None])
    live32 = live.to(torch.int32)
    pos = torch.where(live, torch.cumsum(live32, dim=1, dtype=torch.int32)
                      - 1, n).long()                     # n: dropped
    out = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
    out.scatter_(1, pos, words.to(torch.int32) & 0xFFFF)
    return (out[:, :n].contiguous(),
            torch.sum(live32, dim=1, dtype=torch.int32))


def lanes_to_bytes(words, nwords, states) -> list[bytes]:
    """Per-lane wire bytes from compact_lanes' form (host numpy): u32
    final state (little-endian) ++ the lane's u16 words; a lane that
    coded nothing (no word, the start state) is empty."""
    words = np.asarray(words)
    nwords = np.asarray(nwords).reshape(-1)
    states = np.asarray(states).reshape(-1)
    out = []
    for lane in range(words.shape[0]):
        k = int(nwords[lane])
        if k == 0 and int(states[lane]) == ENC_START_STATE:
            out.append(b"")
            continue
        buf = bytearray(int(states[lane]).to_bytes(4, "little"))
        buf += words[lane, :k].astype("<u2").tobytes()
        out.append(bytes(buf))
    return out


def assemble_global(flat, nw, states, lane_counts) -> list[bytes]:
    """Global-compacted output -> per-lane wire bytes (host numpy pass):
    u32 final state (little-endian) ++ the lane's u16 words.  flat, nw,
    states are host arrays; a lane with count 0 is empty."""
    flat = np.asarray(flat).view(np.uint16)
    nwf = np.asarray(nw).reshape(-1).astype(np.int64)
    states = np.asarray(states).reshape(-1)
    offs = np.concatenate([[0], np.cumsum(nwf)])
    out = []
    for i, c in enumerate(lane_counts):
        if c == 0:
            out.append(b"")
            continue
        buf = bytearray(int(states[i]).to_bytes(4, "little"))
        buf += flat[offs[i]:offs[i + 1]].astype("<u2").tobytes()
        out.append(bytes(buf))
    return out
