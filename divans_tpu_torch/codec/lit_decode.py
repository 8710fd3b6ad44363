"""Deferred literal decode of a lane group: the CUDA kernel, its wrapper
and its plain PyTorch version.

`decode_group` is the port of the Pallas kernel
divans_tpu/codec/pallas_decode.py:182 (`_make_lit_kernel`) together with
the scan around it, `_decode_lit_scan_q` (:377): every chunk of every
lane of a group, the stream switches, the premix and the lagged commit;
given the carry of an earlier call (`carry_in`, :695-705), it resumes
every lane where it stopped.  On a CUDA tensor it launches
csrc/lit_decode.cu once (built by cuda_build with nvcc for sm_90a at
first use, bound through ctypes) or raises; on a CPU tensor it runs
`decode_group_plain`, the same function written as a loop over the
chunks: `lit_decode_chunk_plain` (a loop over the chunk's bytes, vector
ops over the lanes) decodes each chunk against the premixed model, then
the commit of codec/lit_model.py.  The kernel source documents the
contract.

Inputs: the lane queues as `decode.LaneQueues.to` gives them (words
int32[L,W], counts int32[L], state0, n_lit, woff int32[F,L], lcmap
int32[F,L,64], spd int32[F,L,6], luts int32[512]), perm int32[384]
(kernel plane -> rebased row, lit_model.planes), the renorm passes of
each commit, the chunk count and the bytes a chunk, and optionally a
carry to resume from (`idle_carry`, or a call's final carry; the queue
tables may have grown since, rows only appended).  Outputs: the bytes
uint8[L, n_steps*s] and the final carry, a dict of int32 tensors
(CARRY).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build
from ..ans.coder_np import RENORM_BITS, SCALE_MASK, STATE_LOW
from ..constants import LOG2_SCALE
from ..probability import cdf16
from ..probability.weights import bit_length_pos
from . import lit_model
from .deferred import ADJ_CLAMP

N_HI = 64
N_PLANES_MIX = 192
NAME = "lit_decode"
_SIGNATURES = {"dtpu_lit_decode_group":
               [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
               + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 16}
# the final carry of a lane group: per lane scalars [L], the committed
# model [L,385,16], the mixer weights [L,2,3] and the last chunk's pend
# (add [L,385,16], limsum and cnt [L,385], wadj [L,2,2])
SCALARS = ("state", "cursor", "p1", "p2", "n_rem", "fidx")
CARRY = SCALARS + ("committed", "weights", "add", "limsum", "cnt", "wadj")
_TENSORS = CARRY[len(SCALARS):]

# kernel launches, counted where the wrapper launches (and nowhere else)
LAUNCHES = 0


def build():
    """csrc/lit_decode.cu, compiled for sm_90a at first use, loaded."""
    return cuda_build.load(NAME, _SIGNATURES)


def _carry_shapes(lanes: int) -> dict:
    r = lit_model.R_LIT
    return {**{k: (lanes,) for k in SCALARS},
            "committed": (lanes, r, 16), "weights": (lanes, 2, 3),
            "add": (lanes, r, 16), "limsum": (lanes, r), "cnt": (lanes, r),
            "wadj": (lanes, 2, 2)}


def idle_carry(lanes: int, device) -> dict:
    """The empty-queue start (the reference's _resume_init_carry): every
    lane idle (fidx -1, n_rem 0) with a fresh model, so each lane's first
    stream loads through the in-loop switch; the bytes equal those of the
    preloaded start."""
    dev = torch.device(device)
    committed, weights, pend = lit_model.init_state(lanes, dev)
    carry = {k: torch.zeros(lanes, dtype=torch.int32, device=dev)
             for k in SCALARS}
    carry["fidx"] -= 1
    return dict(carry, committed=committed, weights=weights,
                **dict(zip(("add", "limsum", "cnt", "wadj"), pend)))


def from_tpu_carry(j_carry) -> dict:
    """The JAX package's scan carry (committed [B,16,R], weights, the pend
    dict in [B,16,R] layout, state, cursor, p1, p2, n_rem, fidx,
    lcmap_cur, spd_cur) as the port's carry on the CPU; the current
    lcmap and speeds are row fidx of the tables, so they are dropped."""
    (committed, weights, pend, state, cursor, p1, p2, n_rem, fidx,
     _lcmap, _spd) = j_carry

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.int32))
    return {"state": t(state), "cursor": t(cursor), "p1": t(p1),
            "p2": t(p2), "n_rem": t(n_rem), "fidx": t(fidx),
            "committed": t(np.swapaxes(np.asarray(committed), 1, 2)),
            "weights": t(weights),
            "add": t(np.swapaxes(np.asarray(pend["add"]), 1, 2)),
            "limsum": t(pend["limsum"]), "cnt": t(pend["cnt"]),
            "wadj": t(pend["wadj"])}


def decode_group(q: dict, perm, n_pass: int, n_steps: int, s_bytes: int,
                 carry: dict | None = None):
    """Decode n_steps chunks of every lane of the group q, from the
    preloaded start or, given `carry`, from where each lane stopped:
    (bytes, final carry)."""
    global LAUNCHES
    dev = q["words"].device
    if dev.type == "cpu":
        return decode_group_plain(q, perm, n_pass, n_steps, s_bytes,
                                  carry=carry)
    if dev.type != "cuda":
        raise ValueError(f"decode_group runs on cuda or cpu, not {dev}")
    lanes, w = q["words"].shape
    f = q["state0"].shape[0]
    check = cuda_build.check
    i32 = torch.int32
    for name, shape in (("words", (lanes, w)), ("counts", (lanes,)),
                        ("state0", (f, lanes)), ("n_lit", (f, lanes)),
                        ("woff", (f, lanes)), ("lcmap", (f, lanes, 64)),
                        ("spd", (f, lanes, 6)), ("luts", (512,))):
        check(name, q[name], i32, shape, dev)
    check("perm", perm, i32, (lit_model.N_PLANES,), dev)
    if w < 1 or f < 1 or s_bytes < 1 or n_steps < 0:
        raise ValueError("empty word rows, queues or chunk")
    carry_in = [None] * (1 + len(_TENSORS))
    if carry is not None:
        for name, shape in _carry_shapes(lanes).items():
            check(f"carry[{name!r}]", carry[name], i32, shape, dev)
        scalars = torch.stack([carry[k] for k in SCALARS])
        carry_in = [scalars.data_ptr()] + [carry[k].data_ptr()
                                           for k in _TENSORS]
    lib = build()
    out = torch.empty((lanes, n_steps * s_bytes), dtype=torch.uint8,
                      device=dev)
    shapes = _carry_shapes(lanes)
    res = {"scalars": torch.empty((len(SCALARS), lanes), dtype=i32,
                                  device=dev),
           **{k: torch.empty(shapes[k], dtype=i32, device=dev)
              for k in _TENSORS}}
    with cuda_build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dtpu_lit_decode_group(
            q["words"].data_ptr(), w,
            *[q[k].data_ptr() for k in ("counts", "state0", "n_lit", "woff",
                                        "lcmap", "spd", "luts")],
            perm.data_ptr(),
            lanes, n_steps, s_bytes, n_pass, out.data_ptr(),
            *[res[k].data_ptr() for k in ("scalars",) + _TENSORS],
            *carry_in, stream)
    if rc != 0:
        raise RuntimeError(f"decode_group launch failed: CUDA error {rc}")
    LAUNCHES += 1
    scalars = res.pop("scalars")
    return out, dict(zip(SCALARS, scalars.unbind(0)), **res)


# ------------------------------------------------------------ plain version

def _adj_tables(mix, cm, nib):
    """Per-(plane, sym) mixer adjustments of one nibble class under the
    chunk-frozen tables, [B, P, 16] each for (cm, nib): every byte's
    adjustment is a function of (plane, sym) alone, so the chunk's sum
    is sum(count * adj)."""
    fw = cdf16.freqs_all(mix)
    error = (1 << 15) - fw
    shift = torch.clamp(bit_length_pos(fw * error) - 15, min=0)
    return [torch.clamp((error * (n - fw)) >> shift, -ADJ_CLAMP, ADJ_CLAMP)
            for n in (cdf16.freqs_all(cm), cdf16.freqs_all(nib))]


@torch.inference_mode()
def decode_group_plain(q: dict, perm, n_pass: int, n_steps: int,
                       s_bytes: int, chunk_fn=None,
                       carry: dict | None = None):
    """The same function in plain PyTorch: per chunk, the stream switch,
    the premix, `chunk_fn` (default lit_decode_chunk_plain; a test may
    pass a spy of the same signature), the count histograms, the mixer
    sums and the commit (codec/lit_model.py); from `carry` as
    decode_group."""
    chunk_fn = chunk_fn or lit_decode_chunk_plain
    s = s_bytes
    words, counts, luts = q["words"], q["counts"], q["luts"]
    dev = words.device
    b = counts.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    lanes = torch.arange(b, device=dev)
    perm = perm.long()
    perm2 = lit_model.perm_cm2(dev)
    byte_iota = torch.arange(s, **i32)

    committed0, weights0, pend = lit_model.init_state(b, dev)
    committed, weights = committed0, weights0
    if carry is None:
        fidx = torch.zeros(b, dtype=torch.long, device=dev)
        state = q["state0"][0].clone()
        cursor = q["woff"][0] * 2
        p1 = torch.zeros(b, **i32)
        p2 = torch.zeros(b, **i32)
        n_rem = q["n_lit"][0].clone()
    else:
        state, cursor, p1, p2, n_rem = [carry[k].clone()
                                        for k in SCALARS[:5]]
        fidx = carry["fidx"].long()
        committed, weights = carry["committed"], carry["weights"]
        pend = tuple(carry[k] for k in ("add", "limsum", "cnt", "wadj"))
    out = torch.empty((b, n_steps * s), dtype=torch.uint8, device=dev)

    for step in range(n_steps):
        # ---- stream switch: an exhausted lane with more queued loads its
        # next stream and resets model, mixer, pend, ANS state, context
        nxt = fidx + 1
        sw = (n_rem <= 0) & (nxt < counts)
        fidx = torch.where(sw, nxt, fidx)
        # a lane still idle from idle_carry (fidx -1) reads no table row
        fx = fidx.clamp(min=0)
        live = (fidx >= 0)[:, None]
        state = torch.where(sw, q["state0"][fx, lanes], state)
        cursor = torch.where(sw, q["woff"][fx, lanes] * 2, cursor)
        p1 = torch.where(sw, 0, p1)
        p2 = torch.where(sw, 0, p2)
        n_rem = torch.where(sw, q["n_lit"][fx, lanes], n_rem)
        lcmap = torch.where(live, q["lcmap"][fx, lanes], 0)
        spd = torch.where(live, q["spd"][fx, lanes], 0)
        swb = sw[:, None, None]
        committed = torch.where(swb, committed0, committed)
        weights = torch.where(swb, weights0, weights)
        pend = tuple(torch.where(sw.view(-1, *[1] * (p.ndim - 1)), 0, p)
                     for p in pend)

        # ---- premix the frozen cm/nib plane pairs once per chunk
        g = committed[:, perm]                               # [B, 384, 16]
        nw_lo = (weights[:, 0, 2] & 0xFFFF)[:, None]
        nw_hi = (weights[:, 1, 2] & 0xFFFF)[:, None]
        mix_hi = cdf16.average(g[:, 64:128], g[:, 0:64], nw_hi)
        mix_lo = cdf16.average(g[:, 256:384], g[:, 128:256], nw_lo)
        kmodel = torch.cat([mix_hi, mix_lo], dim=1).to(torch.int16)
        sc_in = torch.stack([state, p1, p2, n_rem, cursor])
        bytes_c, ctx_c, sc_out = chunk_fn(kmodel, words, lcmap, luts, sc_in, s)
        out[:, step * s:(step + 1) * s] = bytes_c

        # ---- per-class count histograms (integer index_add_)
        byte = bytes_c.long()
        hi, lo = byte >> 4, byte & 15
        ctx = ctx_c.long()
        active = byte_iota[None, :] < n_rem[:, None]
        cnt_hi, cnt_lo = lit_model.count_hists(ctx, hi, lo, active)

        # ---- mixer adjustments: count histograms against adj tables
        wadj_rows = []
        for cnt, mix, cm, nib in ((cnt_hi, mix_hi, g[:, 64:128], g[:, 0:64]),
                                  (cnt_lo, mix_lo, g[:, 256:384],
                                   g[:, 128:256])):
            wadj_rows.append(torch.stack(
                [torch.sum(cnt * a, dim=(1, 2), dtype=torch.int32)
                 for a in _adj_tables(mix, cm, nib)], dim=-1))
        wadj = torch.stack([wadj_rows[1], wadj_rows[0]], dim=1)   # [B,2,2]

        new_pend = lit_model.chunk_pend(cnt_hi, cnt_lo, spd, wadj, perm2)
        # ---- commit the previous chunk's updates (lag 1)
        committed, weights = lit_model.apply_pend(committed, weights, pend,
                                                  n_pass)
        pend = new_pend
        state = sc_out[0]
        cursor = cursor + sc_out[3]
        p1, p2 = sc_out[1], sc_out[2]
        n_rem = n_rem - s
    carry = dict(zip(CARRY, (state, cursor, p1, p2, n_rem, fidx, committed,
                             weights) + tuple(pend)))
    return out, {k: v.to(torch.int32) for k, v in carry.items()}


def lit_decode_chunk_plain(model, words, lcmap, luts, sc_in, s_bytes: int):
    """One chunk for every lane, the function the TPU kernel computed:
    a loop over the chunk's bytes, vector ops over the lanes (gathers on
    the planes and word rows).  model int16[B,192,16] premixed planes,
    words int32[B,W] packed renorm words (two u16 per int32, little word
    first), lcmap int32[B,64], luts int32[512], sc_in int32[5,B] (state,
    p1, p2, n_rem, halfword cursor) -> bytes uint8[B,s], ctx uint8[B,s],
    sc_out int32[4,B] (state, p1, p2, pulls)."""
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
