"""The adaptive profile's decode scan (chunk_nibbles=0): the whole command
FSM of a metablock, as a CUDA kernel, its wrapper and its plain PyTorch
version.

`decode_scan` is the port of the reference's XLA while_loop
divans_tpu/codec/jax_decode.py:98 (`decode_scan`; no Pallas kernel).  On
a CUDA tensor it launches csrc/scan_decode.cu (built by cuda_build with
nvcc for sm_90a at first use, bound through ctypes), a block of two
warps a frame (the cmd stream's FSM on one, the literals and copies on
the other), or raises; on a CPU tensor it runs `decode_scan_plain`,
jax_decode's body_once transliterated into PyTorch over all lanes in
lockstep.

Inputs are `pack_frames`'s (the port of jax_engine.pack_frames): per
frame the cmd and lit streams' u32 states as int32 [B] (two's
complement), their u16 words as int32 [B, Wc] and [B, Wl] (Wc, Wl powers
of two, read at pos % W), raw_len int32 [B]; the window width W =
next_pow2(max raw_len + 1) and max_steps = 8 W + 16384 micro-steps.
Output: (window uint8 [B, W], ok bool [B], wpos int32 [B]); a lane the
scan flags (ok false: dict commands, block switches, out-of-range
contexts, corrupt streams, the step cut) is decoded again on the host by
the caller.  A lane runs until DONE or ERROR or for max_steps
micro-steps rounded up to a multiple of UNROLL (the reference tests its
loop condition every UNROLL micro-steps, and a stopped lane's steps are
no-ops).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import constants, cuda_build
from ..ans.coder_np import RENORM_BITS, STATE_LOW, bytes_to_lane
from ..probability import cdf16
from ..probability.weights import NORM_WEIGHT_INIT, bit_length_pos, update
from .layout import PROFILES, ModelLayout
from .model_pass import div_table, model_in_shared

NAME = "scan_decode"
_SIGNATURES = {"dtpu_scan_decode": [ctypes.c_void_p] * 2 + [ctypes.c_int]
               + [ctypes.c_void_p] * 2 + [ctypes.c_int]
               + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
               + [ctypes.c_void_p] * 7,
               "dtpu_scan_decode_max_shared": [],
               "dtpu_scan_decode_n_params": []}

CMD_ROWS = 256     # csrc/scan_decode.cu kCmdRows: the cmd rows it caches
SCALE_MASK = (1 << 15) - 1
COPY_CHUNK = 8
UNROLL = 4

# ----------------------------------------------------------------- states
DONE = 0
BEGIN = 1
L_CS, L_BEG, L_LAST, L_MANT, L_HI, L_LO = 2, 3, 4, 5, 6, 7
C_CS, C_BEG, C_LAST, C_MANT = 8, 9, 10, 11
C_DMN, C_DBEG, C_DLAST, C_DMANT = 12, 13, 14, 15
COPY_RUN = 16
P_ONLY, P_DCM, P_PD, P_SPD, P_CMN, P_CF, P_CS, P_MVMODE = \
    17, 18, 19, 20, 21, 22, 23, 24
ERROR = 25
NSTATES = 26

# per-state blend speeds (inc, lim); 0 where unused or computed at runtime
SPEED_TAB = np.zeros((NSTATES, 2), np.int32)
for _st, _sp in {
    BEGIN: (0x180, 0x4000),                       # ROCKET (cc)
    L_CS: (0x30, 0x4000), L_BEG: (0x10, 0x2000),  # MED, MUD
    L_LAST: (0x10, 0x2000), L_MANT: (0x10, 0x2000),
    C_CS: (0x10, 0x2000), C_BEG: (0x60, 0x4000),  # MUD, FAST
    C_LAST: (0x60, 0x4000), C_MANT: (0x20, 0x1000),   # FAST, SLOW
    C_DMN: (0x20, 0x1000), C_DBEG: (0x20, 0x1000),    # SLOW
    C_DLAST: (0x180, 0x4000),                     # ROCKET
    C_DMANT: (0, 0),                              # runtime
    P_ONLY: (0x30, 0x4000), P_DCM: (0x30, 0x4000),
    P_PD: (0x60, 0x4000), P_SPD: (0x60, 0x4000),
    P_CMN: (0x30, 0x4000), P_CF: (0x30, 0x4000), P_CS: (0x30, 0x4000),
    P_MVMODE: (0x30, 0x4000),
}.items():
    SPEED_TAB[_st] = _sp

# the literal context luts of the four prediction modes, int32 [4, 256]
LUT0 = np.stack([constants.literal_lut0(m).astype(np.int32) for m in range(4)])
LUT1 = np.stack([constants.literal_lut1(m).astype(np.int32) for m in range(4)])

# the segments whose offsets the kernel reads, in csrc/scan_decode.cu's
# Param order, then the profile's dimensions
PARAM_SEGS = ("cc", "ll_cs", "ll_beg", "ll_last", "ll_mant", "lit_hi",
              "lit_lo", "cm_first", "cm_second", "c_ccs", "c_cbeg",
              "c_clast", "c_cmant", "c_dmn", "c_dbeg", "c_dlast", "c_dmant",
              "pm_only", "pm_dcm", "pm_pd", "pm_palette", "pm_cmn", "pm_cf",
              "pm_cs", "pm_mvmode")
N_PARAMS = len(PARAM_SEGS) + 6

# each state's model row: its segment's offset plus a state term (0 for
# the states that code nothing); L_HI and L_LO compute theirs whole
_STATE_SEG = {BEGIN: "cc", L_CS: "ll_cs", L_BEG: "ll_beg",
              L_LAST: "ll_last", L_MANT: "ll_mant", C_CS: "c_ccs",
              C_BEG: "c_cbeg", C_LAST: "c_clast", C_MANT: "c_cmant",
              C_DMN: "c_dmn", C_DBEG: "c_dbeg", C_DLAST: "c_dlast",
              C_DMANT: "c_dmant", P_ONLY: "pm_only", P_DCM: "pm_dcm",
              P_PD: "pm_pd", P_SPD: "pm_palette", P_CMN: "pm_cmn",
              P_CF: "pm_cf", P_CS: "pm_cs", P_MVMODE: "pm_mvmode"}

# kernel launches, counted where the wrapper launches (and nowhere else)
LAUNCHES = 0


def build():
    """csrc/scan_decode.cu, compiled for sm_90a at first use, loaded."""
    return cuda_build.load(NAME, _SIGNATURES)


def layout_of(profile: str) -> ModelLayout:
    """The adaptive layout of a profile (no lo bucketing)."""
    return ModelLayout(PROFILES[profile], lo_bucketed=False)


def params(profile: str) -> np.ndarray:
    """The kernel's int32 parameters: PARAM_SEGS' offsets, (rows, lit_sel,
    lo_shift, nctx_lo, nctx, nd), then LUT0 and LUT1."""
    lay = layout_of(profile)
    p = lay.profile
    head = [lay.segments[s][0] for s in PARAM_SEGS] + [
        lay.num_rows, p.lit_sel, lay.lo_shift, lay.nctx_lo, p.nctx, p.nd]
    return np.concatenate([np.array(head, np.int32), LUT0.reshape(-1),
                           LUT1.reshape(-1)]).astype(np.int32)


def next_pow2(n: int) -> int:
    return 1 << max(4, (n - 1).bit_length())


def _i32(state: int) -> int:
    """A u32 state as int32 (two's complement)."""
    return ((state + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def pack_frames(frames):
    """frames -> decode_scan's inputs as numpy arrays: (cmd_states,
    cmd_words, lit_states, lit_words, raw_len, window_size, max_steps)."""
    b = len(frames)
    raw_len = np.array([f.raw_len for f in frames], np.int32)
    wc = next_pow2(max(1, max((len(f.cmd) - 4) // 2 for f in frames)))
    wl = next_pow2(max(1, max((len(f.lit) - 4) // 2 for f in frames)))
    cmd_states = np.zeros(b, np.int32)
    lit_states = np.zeros(b, np.int32)
    cmd_words = np.zeros((b, wc), np.int32)
    lit_words = np.zeros((b, wl), np.int32)
    for i, f in enumerate(frames):
        s, cmd_words[i], _ = bytes_to_lane(f.cmd, wc)
        cmd_states[i] = _i32(s)
        s, lit_words[i], _ = bytes_to_lane(f.lit, wl)
        lit_states[i] = _i32(s)
    window_size = next_pow2(int(raw_len.max()) + 1)
    max_steps = 8 * window_size + 16384
    return (cmd_states, cmd_words, lit_states, lit_words, raw_len,
            window_size, max_steps)


def decode_scan(cmd_states, cmd_words, lit_states, lit_words, raw_len,
                profile: str, window_size: int, max_steps: int):
    """(window uint8 [B, W], ok bool [B], wpos int32 [B]) of B frames."""
    dev = raw_len.device
    if dev.type == "cpu":
        return decode_scan_plain(cmd_states, cmd_words, lit_states,
                                 lit_words, raw_len, profile, window_size,
                                 max_steps)
    return _launch(cmd_states, cmd_words, lit_states, lit_words, raw_len,
                   profile, window_size, max_steps, None)


def decode_scan_clocks(cmd_states, cmd_words, lit_states, lit_words,
                       raw_len, profile: str, window_size: int,
                       max_steps: int):
    """decode_scan's launch on the card, with each frame's two warps
    timed: ((window, ok, wpos), clocks int64 [B, 4]), the cmd warp's and
    the literal warp's finish in SM cycles (clock64) from the block's
    start, then the cycles each waited on the other."""
    b = raw_len.shape[0]
    clocks = torch.zeros((b, 4), dtype=torch.int64, device=raw_len.device)
    out = _launch(cmd_states, cmd_words, lit_states, lit_words, raw_len,
                  profile, window_size, max_steps, clocks)
    return out, clocks


def _launch(cmd_states, cmd_words, lit_states, lit_words, raw_len,
            profile: str, window_size: int, max_steps: int, clocks):
    global LAUNCHES
    dev = raw_len.device
    if dev.type != "cuda":
        raise ValueError(f"decode_scan runs on cuda or cpu, not {dev}")
    b = raw_len.shape[0]
    wc, wl = cmd_words.shape[1], lit_words.shape[1]
    check = cuda_build.check
    for name, t, shape in (("cmd_states", cmd_states, (b,)),
                           ("cmd_words", cmd_words, (b, wc)),
                           ("lit_states", lit_states, (b,)),
                           ("lit_words", lit_words, (b, wl)),
                           ("raw_len", raw_len, (b,))):
        check(name, t, torch.int32, shape, dev)
    for name, w in (("cmd_words", wc), ("lit_words", wl),
                    ("window_size", window_size)):
        if w < 1 or w & (w - 1):
            raise ValueError(f"{name} width {w} is not a power of two")
    lay = layout_of(profile)
    if lay.segments["lit_hi"][0] > CMD_ROWS:
        raise ValueError(f"{profile}: more cmd rows than the kernel caches")
    lib = build()
    window = torch.zeros((b, window_size), dtype=torch.uint8, device=dev)
    ok = torch.zeros((b,), dtype=torch.uint8, device=dev)
    wpos = torch.zeros((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return window, ok.bool(), wpos
    if int(raw_len.max()) >= window_size:
        raise ValueError("a frame's raw_len does not fit the window")
    prm = torch.from_numpy(params(profile)).to(dev)
    scratch = None
    if not model_in_shared(lay.num_rows):
        scratch = torch.empty((b, lay.num_rows, 16), dtype=torch.int16,
                              device=dev)
    with cuda_build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dtpu_scan_decode(
            cmd_states.data_ptr(), cmd_words.data_ptr(), wc,
            lit_states.data_ptr(), lit_words.data_ptr(), wl,
            raw_len.data_ptr(),
            prm.data_ptr(), lay.num_rows, max_steps, window_size, b,
            window.data_ptr(), ok.data_ptr(), wpos.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            div_table(dev).data_ptr(),
            None if clocks is None else clocks.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"decode_scan launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return window, ok.bool(), wpos


@functools.lru_cache(maxsize=None)
def _tables(profile: str, device):
    """(speed table [26, 2], lut0 and lut1 flat [1024], each state's
    segment offset [26]) int32 on `device`."""
    lay = layout_of(profile)
    base = np.zeros(NSTATES, np.int32)
    for s, name in _STATE_SEG.items():
        base[s] = lay.segments[name][0]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (SPEED_TAB, LUT0.reshape(-1), LUT1.reshape(-1),
                           base))


def _rum4(x):
    """round_up_mod_4."""
    return ((x - 1) | 3) + 1


def _u8_to_speed(b):
    lv = torch.clamp((b >> 3) - 1, min=0)
    val = (1 << lv) | (((b & 0x7) << lv) >> 3)
    return torch.where(b < 8, 0, val)


def _gather_row(i, r: int):
    """XLA's gather index: a negative index plus r, then clamped."""
    return torch.clamp(torch.where(i < 0, i + r, i), 0, r - 1)


def _scatter_row(i, r: int):
    """XLA's scatter index: a negative index plus r; r (the trash row)
    where still outside [0, r)."""
    j = torch.where(i < 0, i + r, i)
    return torch.where((j < 0) | (j >= r), r, j)


@torch.inference_mode()
def decode_scan_plain(cmd_states, cmd_words, lit_states, lit_words, raw_len,
                      profile: str, window_size: int, max_steps: int):
    """The same function as `decode_scan` in plain PyTorch: body_once
    over all lanes in lockstep.  The model, window, maps and speeds carry
    one extra row or column that takes the writes the reference drops."""
    lay = layout_of(profile)
    p = lay.profile
    dev = raw_len.device
    b = raw_len.shape[0]
    w_sz = window_size
    r = lay.num_rows
    i32 = dict(dtype=torch.int32, device=dev)
    speed_tab, lut0, lut1, base = _tables(profile, dev)
    bidx = torch.arange(b, device=dev)

    def seg(name):
        return lay.segments[name][0]

    wc, wl = cmd_words.shape[1], lit_words.shape[1]
    st = torch.full((b,), BEGIN, **i32)
    cs, ls = cmd_states.clone(), lit_states.clone()
    cp = torch.zeros((b,), **i32)
    lp = torch.zeros((b,), **i32)
    model = cdf16.cdf_init((b, r + 1), device=dev).clone()
    weights = torch.tensor([1, 1, NORM_WEIGHT_INIT], **i32).repeat(b, 2, 1)
    window = torch.zeros((b, w_sz + 1), dtype=torch.uint8, device=dev)
    wpos = torch.zeros((b,), **i32)
    l4s = torch.full((b,), 3 << 4, **i32)
    dlru = torch.tensor([4, 11, 15, 16], **i32).repeat(b, 1)
    llen = torch.ones((b,), **i32)
    clen = torch.ones((b,), **i32)
    dlen = torch.ones((b,), **i32)
    zero = torch.zeros((b,), **i32)
    nb, dist, acc, lrem, first, r0, tmpa, cnt, which, cmidx, aprior = \
        (zero.clone() for _ in range(11))
    pm_mode = torch.full((b,), 3, **i32)
    combine = zero.clone()
    ar13 = torch.arange(13, **i32)
    cmap_lru = ar13.repeat(b, 1)
    lcm = torch.zeros((b, 65), **i32)
    dcm0 = torch.tensor([0, 1, 2, 3, 0], **i32)
    dcm = dcm0.repeat(b, 1)
    speeds = torch.tensor([[0x10, 0x2000]], **i32).repeat(b, 5, 1)
    offs = torch.arange(COPY_CHUNK, **i32)[None]
    n_micro = -(-max_steps // UNROLL) * UNROLL

    def upd(mask, cur, new):
        return torch.where(mask, new, cur)

    for _ in range(max(0, n_micro)):
        # lanes by state: a block whose state no lane is in changes
        # nothing (its masks are all false), so it is skipped
        n = torch.bincount(st, minlength=NSTATES).tolist()
        if n[DONE] + n[ERROR] == b:
            break
        use_lit = (st == L_HI) | (st == L_LO)
        nocode = (st == DONE) | (st == ERROR) | (st == COPY_RUN)
        use_cmd = ~use_lit & ~nocode

        # ---- literal context (only consumed by L_HI/L_LO lanes)
        lit_any = n[L_HI] + n[L_LO] > 0
        hi_flat = lo_flat = cm_hi = cm_lo = zero
        if lit_any:
            prev_byte = torch.where(wpos > 0, window[
                bidx, torch.clamp(wpos - 1, 0, w_sz - 1)].to(torch.int32), 0)
            prev_prev = torch.where(wpos > 1, window[
                bidx, torch.clamp(wpos - 2, 0, w_sz - 1)].to(torch.int32), 0)
            selected = lut0[pm_mode * 256 + prev_byte] \
                | lut1[pm_mode * 256 + prev_prev]
            ctx = lcm[bidx, selected & 63]
            if p.lit_sel == 0:
                ctx_lo = ctx >> lay.lo_shift
                hi_flat = seg("lit_hi") + ctx
                lo_flat = seg("lit_lo") + ctx_lo * 16 + r0
                cm_hi = seg("cm_first") + ctx
                cm_lo = seg("cm_second") + r0 * lay.nctx_lo + ctx_lo
            else:
                hi_flat = seg("lit_hi") + prev_byte
                lo_flat = seg("lit_lo") + prev_byte * 16 + r0
                cm_hi = seg("cm_first") + ctx
                cm_lo = seg("cm_second") + r0 * lay.nctx_lo + ctx

        # ---- per-state cmd-table row (the blocks of absent states skipped)
        cs_index = ((l4s >> 4) & 3) + 4 * torch.clamp(llen - 1, max=3)
        fi_c = torch.remainder(clen, 4) + 1
        fi_d = (dlen & 3) + 1
        term = torch.where(st == BEGIN, l4s >> 4, 0)
        for s, t in (
                (L_HI, lambda: hi_flat), (L_LO, lambda: lo_flat),
                (C_CS, lambda: cs_index),
                (C_MANT, lambda: torch.where(first != 0, fi_c, 0)),
                (C_DMN, lambda: aprior * 2 + (llen < 8).to(torch.int32)),
                (C_DBEG, lambda: aprior * 8 + (bit_length_pos(nb) >> 2)),
                (C_DLAST, lambda: aprior),
                (C_DMANT,
                 lambda: aprior * 5 + torch.where(first != 0, fi_d, 0)),
                (P_SPD, lambda: cnt & 3), (P_CMN, lambda: which),
                (P_CF, lambda: which), (P_CS, lambda: which)):
            if n[s]:
                term = torch.where(st == s, t(), term)
        flat = base[st] + term

        # ---- blend speed for the coded row
        sp = speed_tab[st]
        inc = torch.where(use_lit, speeds[:, 0, 0], sp[:, 0])
        lim = torch.where(use_lit, speeds[:, 0, 1], sp[:, 1])
        is_dmant = st == C_DMANT
        dmant_inc = torch.where(
            first != 0, 0x4 << ((fi_d & 6) << ((fi_d & 2) >> 1)), 0x4)
        inc = torch.where(is_dmant, dmant_inc, inc)
        lim = torch.where(is_dmant, 0x4000, lim)

        # ---- ANS peek (gated per stream)
        pull_c = use_cmd & (cs < STATE_LOW)
        w_c = cmd_words[bidx, torch.remainder(cp, wc)]
        cstate = torch.where(pull_c, (cs << RENORM_BITS) | w_c, cs)
        cp = cp + pull_c.to(torch.int32)
        pull_l = use_lit & (ls < STATE_LOW)
        w_l = lit_words[bidx, torch.remainder(lp, wl)]
        lstate = torch.where(pull_l, (ls << RENORM_BITS) | w_l, ls)
        lp = lp + pull_l.to(torch.int32)
        state = torch.where(use_lit, lstate, cstate)
        slot = state & SCALE_MASK

        # ---- CDF fetch, symbol, advance, mixer, blends
        rows = model[bidx, _gather_row(flat, r)]
        cm_flat = torch.where(st == L_HI, cm_hi,
                              torch.where(st == L_LO, cm_lo, 0))
        cm_rows = model[bidx, _gather_row(cm_flat, r)]
        do_mix = use_lit & (combine != 0)
        # the mixer's work only on a step where some lane mixes (on the
        # others it changes nothing)
        mix_any = lit_any and bool(do_mix.any())
        if mix_any:
            which_w = (st == L_HI).to(torch.int32)
            wsel = weights[bidx, which_w]
            mixed = cdf16.average(cm_rows, rows, wsel[:, 2] & 0xFFFF)
            coded = torch.where(do_mix[:, None], mixed, rows)
        else:
            coded = rows
        v = cdf16.offset_to_sym(coded, slot)
        if mix_any:
            start, freq = cdf16.sym_to_start_freq_xla(
                torch.cat([coded, cm_rows, rows]), v.repeat(3))
            start = start[:b]
            freq, p_cm, p_nib = freq.view(3, b)
        else:
            start, freq = cdf16.sym_to_start_freq_xla(coded, v)
        adv = freq * (state >> 15) + slot - start
        cs = torch.where(use_cmd, adv, cstate)
        ls = torch.where(use_lit, adv, lstate)
        # blends: a no-code lane writes row 0 unchanged and a lane that
        # does not mix row 0 at the cm slot; both land on the trash row
        rows2 = cdf16.blend(rows, v, torch.where(nocode, 0, inc),
                            torch.where(nocode, 0x4000, lim))
        model[bidx, torch.where(nocode, r, _scatter_row(flat, r))] = rows2
        if mix_any:
            new_w = torch.stack(update(wsel[:, 0], wsel[:, 1], p_cm, p_nib,
                                       freq), -1)
            weights[bidx, which_w] = torch.where(do_mix[:, None], new_w,
                                                 wsel)
            cm_sp = speeds[bidx, torch.where(st == L_HI, 3, 2)]
            cm2 = cdf16.blend(cm_rows, v, cm_sp[:, 0], cm_sp[:, 1])
            model[bidx, torch.where(do_mix, _scatter_row(cm_flat, r),
                                    r)] = cm2

        # =========================== transitions ===========================
        st2 = st
        err = torch.zeros((b,), dtype=torch.bool, device=dev)
        do_setup = torch.zeros((b,), dtype=torch.bool, device=dev)
        setup_d = zero
        tmpa_n, r0_n, cnt_n, which_n, cmidx_n = tmpa, r0, cnt, which, cmidx
        cmap_lru_n = cmap_lru
        cmap_val = zero
        do_obs = torch.zeros((b,), dtype=torch.bool, device=dev)

        # --- BEGIN
        if n[BEGIN]:
            m = st == BEGIN
            st2 = upd(m & (v == 0xF), st2, DONE)
            err |= m & (v == 0xF) & (wpos != raw_len)
            ml = m & (v == 3)
            l4s = upd(ml, l4s, ((l4s >> 2) | 128) & 0xFF)
            st2 = upd(ml, st2, L_CS)
            tmpa_n = torch.where(ml, 0, tmpa)
            mc = m & (v == 1)
            l4s = upd(mc, l4s, ((l4s >> 2) | 64) & 0xFF)
            st2 = upd(mc, st2, C_CS)
            mp = m & (v == 7)
            st2 = upd(mp, st2, P_ONLY)
            cmap_lru_n = torch.where(mp[:, None], ar13, cmap_lru)
            dcm = torch.where(mp[:, None], dcm0, dcm)
            lcm = torch.where(mp[:, None], 0, lcm)
            err |= m & ((v == 2) | (v == 4) | (v == 5) | (v == 6) | (v == 0)
                        | ((v >= 8) & (v <= 14)))

        # --- L_CS
        if n[L_CS]:
            m = st == L_CS
            short = m & (v < 14)
            nb = upd(short, nb, v + 1)
            llen = upd(short, llen, v + 1)
            st2 = upd(short, st2, L_HI)
            st2 = upd(m & (v == 14), st2, L_BEG)
            esc = m & (v == 15)
            err |= esc & (tmpa != 0)
            tmpa_n = torch.where(esc, 1, tmpa_n)

        # --- L_BEG
        if n[L_BEG]:
            m = st == L_BEG
            st2 = upd(m & (v == 15), st2, L_LAST)
            m2 = m & (v <= 1)
            nb = upd(m2, nb, 15 + v)
            st2 = upd(m2, st2, L_HI)
            m3 = m & (v >= 2) & (v < 15)
            lrem = upd(m3, lrem, _rum4(v - 1))
            acc = upd(m3, acc, 1 << torch.clamp(v - 1, max=30))
            first = upd(m3, first, 0)
            st2 = upd(m3, st2, L_MANT)

        # --- L_LAST
        if n[L_LAST]:
            m = st == L_LAST
            lrem = upd(m, lrem, _rum4(v + 14))
            acc = upd(m, acc, 1 << torch.clamp(v + 14, max=30))
            err |= m & (v + 14 >= 31)
            st2 = upd(m, st2, L_MANT)

        # --- L_MANT
        if n[L_MANT]:
            m = st == L_MANT
            nrem = lrem - 4
            acc = upd(m, acc, acc | (v << torch.clamp(nrem, min=0)))
            lrem = upd(m, lrem, nrem)
            fin = m & (nrem == 0)
            nb = upd(fin, nb, acc + 15)
            llen = upd(fin, llen, acc + 15)
            st2 = upd(fin, st2, L_HI)

        # --- L_HI
        if n[L_HI]:
            m = st == L_HI
            r0_n = upd(m, r0, v)
            st2 = upd(m, st2, L_LO)

        # --- L_LO: write the byte
        if n[L_LO]:
            m = st == L_LO
            err |= m & (wpos >= raw_len)
            byte = ((r0 << 4) | v).to(torch.uint8)
            tgt = torch.where(m & (wpos < raw_len) & (wpos < w_sz), wpos, w_sz)
            window[bidx, tgt] = byte
            wpos = upd(m, wpos, wpos + 1)
            nb = upd(m, nb, nb - 1)
            st2 = upd(m, st2, torch.where(nb > 0, L_HI, BEGIN))

        # --- C_CS
        if n[C_CS]:
            m = st == C_CS
            short = m & (v < 15)
            nb = upd(short, nb, v)
            clen = upd(short, clen, bit_length_pos(v))
            st2 = upd(short, st2, C_DMN)
            st2 = upd(m & (v == 15), st2, C_BEG)

        # --- C_BEG
        if n[C_BEG]:
            m = st == C_BEG
            st2 = upd(m & (v == 15), st2, C_LAST)
            m2 = m & (v < 15)
            clen = upd(m2, clen, v + 4)
            lrem = upd(m2, lrem, _rum4(v + 3))
            acc = upd(m2, acc, 1 << torch.clamp(v + 3, max=30))
            first = upd(m2, first, 1)
            st2 = upd(m2, st2, C_MANT)

        # --- C_LAST
        if n[C_LAST]:
            m = st == C_LAST
            clen = upd(m, clen, v + 19)
            lrem = upd(m, lrem, _rum4(v + 18))
            acc = upd(m, acc, 1 << torch.clamp(v + 18, max=30))
            err |= m & (v + 18 >= 31)
            first = upd(m, first, 1)
            st2 = upd(m, st2, C_MANT)

        # --- C_MANT
        if n[C_MANT]:
            m = st == C_MANT
            nrem = lrem - 4
            acc = upd(m, acc, acc | (v << torch.clamp(nrem, min=0)))
            lrem = upd(m, lrem, nrem)
            first = upd(m, first, 0)
            fin = m & (nrem == 0)
            nb = upd(fin, nb, acc)
            st2 = upd(fin, st2, C_DMN)

        # entering C_DMN: the distance prior
        if n[C_CS] or n[C_MANT]:
            entering = (st2 == C_DMN) & (st != C_DMN)
            aprior = upd(entering, aprior, dcm[
                bidx, torch.clamp(torch.clamp(nb, min=2) - 2, max=3)])

        # --- C_DMN
        if n[C_DMN]:
            m = st == C_DMN
            st2 = upd(m & (v == 15), st2, C_DBEG)
            m2 = m & (v < 15)
            lt4 = v < 4
            d_lru = dlru[bidx, torch.clamp(v, max=3)]
            unsigned = v >> 2
            signed = torch.where((v & 1) != 0, -unsigned, unsigned)
            d_calc = dlru[bidx, (v & 2) >> 1] + signed
            d_mn = torch.where(lt4, d_lru, d_calc)
            err |= m2 & ~lt4 & (d_calc <= 0)
            dlen = upd(m2, dlen, bit_length_pos(torch.clamp(d_mn, min=0)))
            do_setup |= m2
            setup_d = upd(m2, setup_d, d_mn)

        # --- C_DBEG
        if n[C_DBEG]:
            m = st == C_DBEG
            m15 = m & (v == 15)
            d15 = dlru[:, 1] - 3
            dlen = upd(m15, dlen, bit_length_pos(torch.clamp(d15, min=0)))
            do_setup |= m15
            setup_d = upd(m15, setup_d, d15)
            st2 = upd(m & (v == 14), st2, C_DLAST)
            m0 = m & (v == 0)
            dlen = upd(m0, dlen, 1)
            do_setup |= m0
            setup_d = upd(m0, setup_d, 1)
            m2 = m & (v >= 1) & (v <= 13)
            dlen = upd(m2, dlen, v + 1)
            lrem = upd(m2, lrem, _rum4(v))
            acc = upd(m2, acc, 1 << torch.clamp(v, max=30))
            first = upd(m2, first, 1)
            st2 = upd(m2, st2, C_DMANT)

        # --- C_DLAST
        if n[C_DLAST]:
            m = st == C_DLAST
            dlen = upd(m, dlen, v + 15)
            lrem = upd(m, lrem, _rum4(v + 14))
            acc = upd(m, acc, 1 << torch.clamp(v + 14, max=30))
            first = upd(m, first, 1)
            st2 = upd(m, st2, C_DMANT)

        # --- C_DMANT
        if n[C_DMANT]:
            m = st == C_DMANT
            nrem = lrem - 4
            acc = upd(m, acc, acc | (v << torch.clamp(nrem, min=0)))
            lrem = upd(m, lrem, nrem)
            first = upd(m, first, 0)
            fin = m & (nrem == 0)
            do_setup |= fin
            setup_d = upd(fin, setup_d, acc)

        # --- copy setup: validate distance, update LRU, start the run
        if n[C_DMN] or n[C_DBEG] or n[C_DMANT]:
            err |= do_setup & ((setup_d <= 0) | (setup_d > wpos))
            d = setup_d
            l0, l1, l2, l3 = dlru.unbind(1)
            new_lru = torch.where(
                (d == l1)[:, None], torch.stack([d, l0, l2, l3], -1),
                torch.where((d == l2)[:, None], torch.stack([d, l0, l1, l3], -1),
                            torch.where((d == l0)[:, None], dlru,
                                        torch.stack([d, l0, l1, l2], -1))))
            dlru = torch.where(do_setup[:, None], new_lru, dlru)
            dist = upd(do_setup, dist, setup_d)
            st2 = upd(do_setup, st2, torch.where(nb > 0, COPY_RUN, BEGIN))

        # --- COPY_RUN: move up to COPY_CHUNK bytes
        if n[COPY_RUN]:
            m = st == COPY_RUN
            k = torch.minimum(torch.clamp(nb, max=COPY_CHUNK), dist)
            err |= m & (wpos + k > raw_len)
            src = torch.clamp(wpos[:, None] - dist[:, None] + offs, 0, w_sz - 1)
            vals = torch.gather(window, 1, src.long())
            ok_w = m & (wpos + k <= raw_len)
            tgt = wpos[:, None] + offs
            tgt = torch.where(ok_w[:, None] & (offs < k[:, None])
                              & (tgt < w_sz), tgt, w_sz)
            window.scatter_(1, tgt.long(), vals)
            wpos = upd(m, wpos, wpos + k)
            nb = upd(m, nb, nb - k)
            st2 = upd(m, st2, torch.where(nb > 0, COPY_RUN, BEGIN))

        # --- prediction-mode header
        if n[P_ONLY]:
            m = st == P_ONLY
            err |= m & (v > 3)
            pm_mode = upd(m, pm_mode, torch.clamp(v, max=3))
            st2 = upd(m, st2, P_DCM)

        if n[P_DCM]:
            m = st == P_DCM
            combine = upd(m, combine, ((v & 3) != 0).to(torch.int32))
            st2 = upd(m, st2, P_PD)

        if n[P_PD]:
            m = st == P_PD
            cnt_n = upd(m, cnt, 0)
            st2 = upd(m, st2, P_SPD)

        if n[P_SPD]:
            m = st == P_SPD
            pt = cnt & 3
            si = cnt >> 2
            t_a = upd(m & (pt == 0), tmpa, v << 3)
            t_a = upd(m & (pt == 1), t_a, t_a | v)
            r0s = upd(m & (pt == 2), r0, v << 3)
            r0s = upd(m & (pt == 3), r0s, r0s | v)
            tmpa_n = torch.where(m, t_a, tmpa_n)
            r0_n = torch.where(m, r0s, r0_n)
            spd_done = m & (pt == 3)
            new_speed = torch.stack([_u8_to_speed(t_a), _u8_to_speed(r0s)],
                                    -1)
            speeds[bidx, torch.where(spd_done, si, 4)] = new_speed
            cnt_n = torch.where(m, cnt + 1, cnt_n)
            fin = m & (cnt == 15)
            which_n = upd(fin, which, 0)
            cmidx_n = upd(fin, cmidx, 0)
            st2 = upd(fin, st2, P_CMN)

        # context maps: mnemonic / escape / eof
        if n[P_CMN]:
            m = st == P_CMN
            meof = m & (v == 14)
            to_dist = meof & (which == 0)
            cmap_lru_n = torch.where(to_dist[:, None], ar13, cmap_lru_n)
            which_n = torch.where(to_dist, 1, which_n)
            cmidx_n = torch.where(to_dist, 0, cmidx_n)
            st2 = upd(meof & (which == 1), st2, P_MVMODE)
            st2 = upd(m & (v == 15), st2, P_CF)
            m13 = m & (v == 13)
            lru_max = torch.max(cmap_lru, dim=1).values
            cmap_val = upd(m13, cmap_val, (lru_max + 1) & 0xFF)
            do_obs |= m13
            mmn = m & (v < 13)
            cmap_val = upd(mmn, cmap_val,
                           cmap_lru[bidx, torch.clamp(v, max=12)])
            do_obs |= mmn

        if n[P_CF]:
            m = st == P_CF
            tmpa_n = torch.where(m, v << 4, tmpa_n)
            st2 = upd(m, st2, P_CS)

        if n[P_CS]:
            m = st == P_CS
            cmap_val = upd(m, cmap_val, tmpa | v)
            do_obs |= m
            st2 = upd(m, st2, P_CMN)

        # obs_context_map_for_lru + store into lcm/dcm
        if n[P_CMN] or n[P_CS]:
            lruc = cmap_lru_n
            eq = lruc == cmap_val[:, None]
            present = eq.any(1)
            pos = torch.argmax(eq.to(torch.int32), 1)
            shift_src = torch.cat([cmap_val[:, None], lruc[:, :-1]], 1)
            keep_tail = present[:, None] & (ar13[None] > pos[:, None])
            lru_obs = torch.where(keep_tail, lruc, shift_src)
            lru_obs = torch.where((present & (pos == 0))[:, None], lruc,
                                  lru_obs)
            cmap_lru_n = torch.where(do_obs[:, None], lru_obs, lruc)
            is_lit_map = do_obs & (which == 0)
            is_dst_map = do_obs & (which == 1)
            err |= is_lit_map & ((cmidx >= 64) | (cmap_val >= p.nctx))
            err |= is_dst_map & ((cmidx >= 4) | (cmap_val >= p.nd))
            lcm[bidx, torch.where(is_lit_map & (cmidx < 64), cmidx, 64)] = \
                torch.where(is_lit_map, cmap_val, 0)
            dcm[bidx, torch.where(is_dst_map & (cmidx < 4), cmidx, 4)] = \
                torch.where(is_dst_map, cmap_val, 0)
            cmidx_n = torch.where(do_obs, cmidx + 1, cmidx_n)

        # mv_mode: profile must match
        if n[P_MVMODE]:
            m = st == P_MVMODE
            err |= m & (v != (0 if p.lit_sel == 0 else 1))
            st2 = upd(m, st2, BEGIN)

        st = torch.where(err, ERROR, st2)
        tmpa, r0, cnt, which, cmidx = tmpa_n, r0_n, cnt_n, which_n, cmidx_n
        cmap_lru = cmap_lru_n
    ok = (st == DONE) & (wpos == raw_len)
    return window[:, :w_sz].contiguous(), ok, wpos

