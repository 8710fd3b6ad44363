"""One chunk of deferred literal decode: the CUDA kernel, its wrapper and
its plain PyTorch version.

`lit_decode_chunk` is the port of the Pallas kernel
divans_tpu/codec/pallas_decode.py:182 (`_make_lit_kernel`).  On a CUDA
tensor it launches csrc/lit_decode.cu (built by cuda_build with nvcc
for sm_90a at first use, bound through ctypes) or raises; on a CPU
tensor it runs `lit_decode_chunk_plain`, the same
function written as a loop over the chunk's bytes with vector ops over
the lanes.  The kernel source documents the contract.

Inputs (natural layout, lanes first): model int16[B,192,16] premixed
planes, words int32[B,W] packed renorm words (two u16 per int32, little
word first), lcmap int32[B,64], luts int32[512] (lut0 ++ lut1), sc_in
int32[5,B] (state, p1, p2, n_rem, halfword cursor).  Outputs: bytes
uint8[B,s], ctx uint8[B,s], sc_out int32[4,B] (state, p1, p2, pulls).
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_build
from ..ans.coder_np import RENORM_BITS, SCALE_MASK, STATE_LOW
from ..constants import LOG2_SCALE
from ..probability import cdf16

N_HI = 64
N_PLANES_MIX = 192
NAME = "lit_decode"
_SIGNATURES = {"dtpu_lit_decode_chunk": [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int] + [ctypes.c_void_p] * 6
                + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}

# kernel launches, counted where the wrapper launches (and nowhere else)
LAUNCHES = 0


def build():
    """csrc/lit_decode.cu, compiled for sm_90a at first use, loaded."""
    return cuda_build.load(NAME, _SIGNATURES)


def lit_decode_chunk(model, words, lcmap, luts, sc_in, s_bytes: int):
    """Decode one chunk for every lane: (bytes, ctx, sc_out)."""
    global LAUNCHES
    dev = model.device
    if dev.type == "cpu":
        return lit_decode_chunk_plain(model, words, lcmap, luts, sc_in,
                                      s_bytes)
    if dev.type != "cuda":
        raise ValueError(f"lit_decode_chunk runs on cuda or cpu, not {dev}")
    b = model.shape[0]
    check = cuda_build.check
    check("model", model, torch.int16, (b, N_PLANES_MIX, 16), dev)
    check("words", words, torch.int32, (b, words.shape[1]), dev)
    check("lcmap", lcmap, torch.int32, (b, 64), dev)
    check("luts", luts, torch.int32, (512,), dev)
    check("sc_in", sc_in, torch.int32, (5, b), dev)
    if words.shape[1] < 1 or s_bytes < 1:
        raise ValueError("empty word rows or chunk")
    lib = build()
    out_b = torch.empty((b, s_bytes), dtype=torch.uint8, device=dev)
    out_c = torch.empty((b, s_bytes), dtype=torch.uint8, device=dev)
    sc_out = torch.empty((4, b), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.dtpu_lit_decode_chunk(
        model.data_ptr(), words.data_ptr(), words.shape[1],
        lcmap.data_ptr(), luts.data_ptr(), sc_in.data_ptr(),
        out_b.data_ptr(), out_c.data_ptr(), sc_out.data_ptr(),
        b, s_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"lit_decode_chunk launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out_b, out_c, sc_out


def lit_decode_chunk_plain(model, words, lcmap, luts, sc_in, s_bytes: int):
    """The same function in plain PyTorch: a loop over the chunk's bytes,
    vector ops over the lanes (gathers on the planes and word rows)."""
    b = model.shape[0]
    dev = model.device
    lanes = torch.arange(b, device=dev)
    w_max = words.shape[1] - 1
    # flat row views: lane l's plane p is row l*192 + p, its word j is
    # element l*W + j (index_select on one axis is the cheap gather)
    planes = model.reshape(b * N_PLANES_MIX, 16).to(torch.int32)
    plane_base = lanes * N_PLANES_MIX
    words_flat = words.reshape(-1)
    word_base = lanes * words.shape[1]
    lc_flat = lcmap.reshape(-1)
    lc_base = lanes * 64
    state, p1, p2, n_rem, cursor = sc_in.clone().unbind(0)
    pulls = torch.zeros_like(state)
    out_b = torch.zeros((b, s_bytes), dtype=torch.uint8, device=dev)
    out_c = torch.zeros((b, s_bytes), dtype=torch.uint8, device=dev)
    lut0, lut1 = luts[:256], luts[256:]

    def nibble(plane, state, pulls, active):
        h = cursor + pulls
        packed = words_flat[word_base + torch.clamp(h >> 1, max=w_max)]
        word = (packed >> ((h & 1) * 16)) & 0xFFFF
        need = active & (state < STATE_LOW)
        state = torch.where(need, (state << RENORM_BITS) | word, state)
        pulls = pulls + need
        cdf = planes[plane_base + plane]
        slot = state & SCALE_MASK
        sym = cdf16.offset_to_sym(cdf, slot)
        start, freq = cdf16.sym_to_start_freq(cdf, sym)
        state = torch.where(active,
                            freq * (state >> LOG2_SCALE) + slot - start, state)
        return sym, state, pulls

    n_act = min(s_bytes, max(0, int(n_rem.max())))
    for t in range(n_act):
        active = t < n_rem
        sel = lut0[p1] | lut1[p2]
        ctx = lc_flat[lc_base + (sel & 63)] & 63
        hi, state, pulls = nibble(ctx, state, pulls, active)
        lo, state, pulls = nibble(N_HI + (ctx >> 3) * 16 + hi,
                                  state, pulls, active)
        byte = (hi << 4) | lo
        out_b[:, t] = torch.where(active, byte, 0).to(torch.uint8)
        out_c[:, t] = torch.where(active, ctx, 0).to(torch.uint8)
        p2 = torch.where(active, p1, p2)
        p1 = torch.where(active, byte, p1)
    sc_out = torch.stack([state, p1, p2, pulls]).to(torch.int32)
    return out_b, out_c, sc_out
