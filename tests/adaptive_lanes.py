"""Host emulations of the adaptive kernels' decompositions, for the tests.

csrc/scan_decode.cu and csrc/model_pass.cu split their serial chains
across warps and lanes; the CUDA sources cannot run off the card, so the
tests hold these step-for-step emulations (plain Python ints, one list
entry for each lane of a row) against the plain versions and the
reference:

* `scan_lanes`: the decode scan as two cooperating warps.  The cmd warp
  decodes the cmd stream alone, tracks wpos from the lengths, numbers
  every micro-step as the serial FSM would, and emits each literal run
  and copy cut to the bytes that run writes before the lane stops; it
  drains the ring (waits until the literal warp has run every record)
  before a header changes the literal state and before it touches a
  literal row.  Records are run eagerly up to each drain, as far ahead
  as an unbounded ring lets the cmd warp run.  The literal warp decodes
  the lit stream against warp-wide rows: every entry's division before
  the symbol is known, the symbol by a ballot, the mixer's norm weight
  by the 256-entry table.
* `model_pass_lanes`: the encode model pass as row chains (the blend
  events grouped by row in step order, each chain recording the
  pre-state entries its steps read, inc-0 events that cannot change a
  row skipped in bulk), then every step's (start, freq) or mixer inputs
  in parallel, then one weight chain a mixer, and the compaction into
  stream lanes.

Every operation is the kernels' int32 arithmetic (csrc/adaptive.cuh).
"""
from __future__ import annotations

import numpy as np

from divans_tpu_torch.codec import scan_decode as sd

CDF_INIT = [4 * (i + 1) for i in range(16)]
WEIGHT_MAX = (1 << 30) - 1
NORM_INIT = 1 << 14
# norm_weight's floor_div(1 << 24, total8) for every 8-bit divisor
INV_TABLE = [0] + [(1 << 24) // d for d in range(1, 256)]


# ------------------------------------------------------ int32 arithmetic

def i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x & 0x80000000 else x


def wrap16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x & 0x8000 else x


def bit_length(x: int) -> int:
    return x.bit_length() if x > 0 else 0


def sra(x: int, s: int) -> int:
    return (-1 if x < 0 else 0) if not 0 <= s <= 31 else x >> s


def xdiv(a: int, b: int) -> int:
    """XLA's jnp `//`: floor division, -1 (a == 0) or -2 by zero."""
    if b == 0:
        return -1 if a == 0 else -2
    return a // b


def lane_divs(c: list[int]) -> list[int]:
    """Every lane's floor(c[i] << 15 / c[15]), before the symbol is
    known."""
    return [xdiv(i32(x << 15), c[15]) for x in c]


def start_freq_of(r: list[int], v: int) -> tuple[int, int]:
    """(start, freq) of symbol v from the lanes' quotients."""
    r_prev = r[v - 1] if v > 0 else 0
    return r_prev + 1, i32(r[v] - r_prev - 1)


def ballot_sym(c: list[int], slot: int) -> int:
    """offset_to_sym: the count of lanes i < 15 with c[i] <= resc."""
    resc = (slot * c[15]) >> 15
    return sum(1 for i in range(15) if c[i] <= resc)


def mix_shift(amax: int, bmax: int) -> int:
    return max(bit_length(amax * bmax) - 15, 0)


def average(ra: int, rb: int, rate: int) -> int:
    """One entry of cdf16.average from its pre-scaled sides."""
    s = i32(ra * rate + rb * ((1 << 15) - rate) + 1)
    return wrap16(s >> 15)


def blend_lanes(c: list[int], v: int, inc: int, lim: int) -> list[int]:
    """cdf16.blend, one entry a lane; the renorm test on lane 15's sum."""
    c = [wrap16(x + (inc if i >= v else 0)) for i, x in enumerate(c)]
    if c[15] >= lim:
        c = [wrap16(cb - (cb >> 2))
             for cb in (wrap16(x + i + 1) for i, x in enumerate(c))]
    return c


def norm_weight(w0: int, w1: int) -> int:
    total = i32(w0 + w1)
    sh = max(bit_length(total) - 8, 0)
    inv = 1 + INV_TABLE[total >> sh]
    num = (w0 >> sh) << 8
    q16 = wrap16(((inv >> 12) * num + (((inv & 0xFFF) * num) >> 12)) >> 12)
    return wrap16(q16 << 7)


def new_weight(prob: int, p1: int, w: int) -> int:
    error = i32((1 << 15) - p1)
    log_geo = bit_length(i32(p1 * error))
    adj = sra(i32(error * i32(prob - p1)), log_geo - 15)
    s = i32(w + adj)
    return min(max(s, 1), WEIGHT_MAX)


def update_weights(w: list[int], p_cm: int, p_nib: int, p1: int) -> None:
    w0, w1 = w[0], w[1]
    if (w0 | w1) & 0x7F000000:
        sh = max(max(bit_length(w0), bit_length(w1)) - 24, 0)
        w0 >>= sh
        w1 >>= sh
    w[0] = new_weight(p_cm, p1, w0)
    w[1] = new_weight(p_nib, p1, w1)
    w[2] = norm_weight(w[0], w[1])


# ------------------------------------------------------------ the scan

def u8_to_speed(b: int) -> int:
    lv = max((b >> 3) - 1, 0)
    return 0 if b < 8 else (1 << lv) | (((b & 7) << lv) >> 3)


def _gather_row(i: int, r: int) -> int:
    j = i + r if i < 0 else i
    return min(max(j, 0), r - 1)


def _scatter_row(i: int, r: int) -> int:
    j = i + r if i < 0 else i
    return -1 if j < 0 or j >= r else j


class _Words:
    """A stream's u16 words, read at pos % W."""

    def __init__(self, state: int, words: np.ndarray):
        self.state = int(state)
        self.words = [int(x) for x in words]
        self.pos = 0

    def peek(self) -> int:
        """The state after its renorm, consuming a word if it is low."""
        if self.state < (1 << 15):
            w = self.words[self.pos % len(self.words)]
            self.state = i32(((self.state & 0xFFFFFFFF) << 16) | w)
            self.pos += 1
        return self.state


def _advance(s: _Words, state: int, start: int, freq: int) -> None:
    slot = state & 0x7FFF
    s.state = i32(freq * (state >> 15) + slot - start)


class _Shared:
    """What the two warps share: the model (a literal row is the literal
    warp's, every other row the cmd warp's) and the header the cmd warp
    writes while the ring is drained."""

    def __init__(self, r: int):
        self.model = [list(CDF_INIT) for _ in range(r)]
        self.lcm = [0] * 64
        self.pm_mode = 3
        self.combine = 0
        self.speeds = [[0x10, 0x2000] for _ in range(4)]


def _cmd_warp(sh: _Shared, cmd: _Words, raw_len: int, prm, n_micro: int,
              lit_base: int):
    """The cmd warp of one lane, a generator of ring records:
    ("lit", n, m) n bytes of a literal run from micro-step m, ("copy", n,
    dist, m), ("drain", why) (the cmd warp waits for the literal warp:
    "header" or "row"), and last ("stop", ok, wpos)."""
    seg = prm[:sd.N_PARAMS - 6]
    r = prm[sd.N_PARAMS - 6]
    lit_sel = prm[sd.N_PARAMS - 5]
    nctx, nd = prm[sd.N_PARAMS - 2], prm[sd.N_PARAMS - 1]
    base = {s: seg[sd.PARAM_SEGS.index(name)]
            for s, name in sd._STATE_SEG.items()}
    st, m, wpos = sd.BEGIN, 0, 0
    l4s, llen, clen, dlen, nb, dist = 3 << 4, 1, 1, 1, 0, 0
    acc = lrem = first = r0 = tmpa = cnt = which = cmidx = aprior = 0
    dlru = [4, 11, 15, 16]
    dcm = [0, 1, 2, 3]
    cmap_lru = list(range(13))
    while st not in (sd.DONE, sd.ERROR) and m < n_micro:
        avail = n_micro - m
        room = raw_len - wpos
        if st == sd.L_HI:
            # a literal run: nb bytes (one when nb <= 0, 2^31 when
            # INT_MIN), two micro-steps a byte; L_LO errs at wpos >=
            # raw_len, its byte dropped
            n = nb if nb >= 1 else (1 << 31 if nb == -(1 << 31) else 1)
            if room < n and 2 * room + 2 <= avail:
                yield ("lit", room, m)
                wpos, m, st = raw_len + 1, m + 2 * room + 2, sd.ERROR
            elif 2 * n <= avail:
                yield ("lit", n, m)
                wpos, m, st = wpos + n, m + 2 * n, sd.BEGIN
                nb = 0 if nb >= 1 or nb == -(1 << 31) else i32(nb - 1)
            else:
                yield ("lit", avail // 2, m)
                wpos, m = wpos + avail // 2, n_micro
            continue
        if st == sd.COPY_RUN:
            # chunks of min(8, nb, dist) bytes, one a micro-step; a chunk
            # past raw_len errs, writes nothing and advances wpos
            c = min(sd.COPY_CHUNK, dist)
            chunks = -(-nb // c)
            err_chunk = room // c if nb > room else None
            if err_chunk is not None and err_chunk < avail:
                yield ("copy", err_chunk * c, dist, m)
                wpos += err_chunk * c + min(c, nb - err_chunk * c)
                m, st = m + err_chunk + 1, sd.ERROR
            elif chunks <= avail:
                yield ("copy", nb, dist, m)
                wpos, m, st, nb = wpos + nb, m + chunks, sd.BEGIN, 0
            else:
                yield ("copy", avail * c, dist, m)
                wpos, m = wpos + avail * c, n_micro
            continue
        # ---- one coded cmd micro-step, the row a warp's 16 lanes
        fi_c = (clen & 3) + 1
        fi_d = (dlen & 3) + 1
        term = {sd.BEGIN: l4s >> 4,
                sd.C_CS: i32(((l4s >> 4) & 3) + i32(4 * min(i32(llen - 1),
                                                             3))),
                sd.C_MANT: fi_c if first else 0,
                sd.C_DMN: aprior * 2 + (1 if llen < 8 else 0),
                sd.C_DBEG: aprior * 8 + (bit_length(nb) >> 2),
                sd.C_DLAST: aprior,
                sd.C_DMANT: aprior * 5 + (fi_d if first else 0),
                sd.P_SPD: cnt & 3, sd.P_CMN: which, sd.P_CF: which,
                sd.P_CS: which}.get(st, 0)
        flat = i32(base[st] + term)
        inc, lim = (int(x) for x in sd.SPEED_TAB[st])
        if st == sd.C_DMANT:
            inc = (0x4 << ((fi_d & 6) << ((fi_d & 2) >> 1))) if first else 4
            lim = 0x4000
        fr, fw = _gather_row(flat, r), _scatter_row(flat, r)
        if fr >= lit_base or fw >= lit_base:
            yield ("drain", "row")  # a literal row: the literal warp waits
        state = cmd.peek()
        row = sh.model[fr]
        v = ballot_sym(row, state & 0x7FFF)
        start, freq = start_freq_of(lane_divs(row), v)
        _advance(cmd, state, start, freq)
        if fw >= 0:
            sh.model[fw] = blend_lanes(row, v, inc, lim)
        m += 1
        # ---- the transition (jax_decode.body_once's, cmd states)
        st2, err, setup, obs = st, False, None, None
        which_old, cmidx_old = which, cmidx
        if st == sd.BEGIN:
            if v == 0xF:
                st2, err = sd.DONE, wpos != raw_len
            elif v == 3:
                l4s, st2, tmpa = ((l4s >> 2) | 128) & 0xFF, sd.L_CS, 0
            elif v == 1:
                l4s, st2 = ((l4s >> 2) | 64) & 0xFF, sd.C_CS
            elif v == 7:
                yield ("drain", "header")   # it changes the literal state
                st2 = sd.P_ONLY
                cmap_lru = list(range(13))
                dcm = [0, 1, 2, 3]
                sh.lcm = [0] * 64
            else:
                err = True
        elif st == sd.L_CS:
            if v < 14:
                nb = llen = v + 1
                st2 = sd.L_HI
            elif v == 14:
                st2 = sd.L_BEG
            else:
                err, tmpa = tmpa != 0, 1
        elif st == sd.L_BEG:
            if v == 15:
                st2 = sd.L_LAST
            elif v <= 1:
                nb, st2 = 15 + v, sd.L_HI
            else:
                lrem, acc, first, st2 = (sd._rum4(v - 1), 1 << min(v - 1, 30),
                                         0, sd.L_MANT)
        elif st == sd.L_LAST:
            lrem, acc = sd._rum4(v + 14), 1 << min(v + 14, 30)
            err, st2 = v + 14 >= 31, sd.L_MANT
        elif st == sd.L_MANT:
            nrem = lrem - 4
            acc, lrem = i32(acc | (v << max(nrem, 0))), nrem
            if nrem == 0:
                nb = llen = i32(acc + 15)
                st2 = sd.L_HI
        elif st == sd.C_CS:
            if v < 15:
                nb, clen, st2 = v, bit_length(v), sd.C_DMN
            else:
                st2 = sd.C_BEG
        elif st == sd.C_BEG:
            if v == 15:
                st2 = sd.C_LAST
            else:
                clen, lrem, acc, first, st2 = (v + 4, sd._rum4(v + 3),
                                               1 << min(v + 3, 30), 1,
                                               sd.C_MANT)
        elif st == sd.C_LAST:
            clen, lrem, acc = v + 19, sd._rum4(v + 18), 1 << min(v + 18, 30)
            err, first, st2 = v + 18 >= 31, 1, sd.C_MANT
        elif st == sd.C_MANT:
            nrem = lrem - 4
            acc, lrem, first = i32(acc | (v << max(nrem, 0))), nrem, 0
            if nrem == 0:
                nb, st2 = acc, sd.C_DMN
        elif st == sd.C_DMN:
            if v == 15:
                st2 = sd.C_DBEG
            else:
                u = v >> 2
                d_calc = i32(dlru[(v & 2) >> 1] + (-u if v & 1 else u))
                d_mn = dlru[min(v, 3)] if v < 4 else d_calc
                err = v >= 4 and d_calc <= 0
                dlen, setup = bit_length(max(d_mn, 0)), d_mn
        elif st == sd.C_DBEG:
            if v == 15:
                d15 = i32(dlru[1] - 3)
                dlen, setup = bit_length(max(d15, 0)), d15
            elif v == 14:
                st2 = sd.C_DLAST
            elif v == 0:
                dlen, setup = 1, 1
            else:
                dlen, lrem, acc, first, st2 = (v + 1, sd._rum4(v),
                                               1 << min(v, 30), 1, sd.C_DMANT)
        elif st == sd.C_DLAST:
            dlen, lrem, acc = v + 15, sd._rum4(v + 14), 1 << min(v + 14, 30)
            first, st2 = 1, sd.C_DMANT
        elif st == sd.C_DMANT:
            nrem = lrem - 4
            acc, lrem, first = i32(acc | (v << max(nrem, 0))), nrem, 0
            if nrem == 0:
                setup = acc
        elif st == sd.P_ONLY:
            err, st2 = v > 3, sd.P_DCM
            sh.pm_mode = min(v, 3)
        elif st == sd.P_DCM:
            sh.combine, st2 = int((v & 3) != 0), sd.P_PD
        elif st == sd.P_PD:
            cnt, st2 = 0, sd.P_SPD
        elif st == sd.P_SPD:
            pt = cnt & 3
            if pt == 0:
                tmpa = v << 3
            elif pt == 1:
                tmpa |= v
            elif pt == 2:
                r0 = v << 3
            else:
                r0 |= v
                sh.speeds[cnt >> 2] = [u8_to_speed(tmpa), u8_to_speed(r0)]
            if cnt == 15:
                which, cmidx, st2 = 0, 0, sd.P_CMN
            cnt += 1
        elif st == sd.P_CMN:
            if v == 14:
                if which_old == 0:
                    cmap_lru, which, cmidx = list(range(13)), 1, 0
                else:
                    st2 = sd.P_MVMODE
            elif v == 15:
                st2 = sd.P_CF
            elif v == 13:
                obs = (max(cmap_lru) + 1) & 0xFF
            else:
                obs = cmap_lru[v]
        elif st == sd.P_CF:
            tmpa, st2 = v << 4, sd.P_CS
        elif st == sd.P_CS:
            obs, st2 = tmpa | v, sd.P_CMN
        elif st == sd.P_MVMODE:
            err, st2 = v != (0 if lit_sel == 0 else 1), sd.BEGIN
        if st2 == sd.C_DMN and st != sd.C_DMN:
            aprior = dcm[min(max(nb, 2) - 2, 3)]
        if setup is not None:
            err = err or setup <= 0 or setup > wpos
            l0, l1, l2, l3 = dlru
            if setup == l1:
                dlru = [setup, l0, l2, l3]
            elif setup == l2:
                dlru = [setup, l0, l1, l3]
            elif setup != l0:
                dlru = [setup, l0, l1, l2]
            dist = setup
            st2 = sd.COPY_RUN if nb > 0 else sd.BEGIN
        if obs is not None:
            pos = cmap_lru.index(obs) if obs in cmap_lru else 12
            cmap_lru = [obs] + cmap_lru[:pos] + cmap_lru[pos + 1:]
            if which_old == 0:
                err = err or cmidx_old >= 64 or obs >= nctx
                if cmidx_old < 64:
                    sh.lcm[cmidx_old] = obs
            else:
                err = err or cmidx_old >= 4 or obs >= nd
                if cmidx_old < 4:
                    dcm[cmidx_old] = obs
            cmidx = cmidx_old + 1
        st = sd.ERROR if err else st2
    yield ("stop", st == sd.DONE and wpos == raw_len, wpos)


class _LitWarp:
    """The literal warp of one lane: runs the records in order, writing
    the window."""

    def __init__(self, sh: _Shared, lit: _Words, window: np.ndarray, prm):
        self.sh, self.lit, self.window = sh, lit, window
        self.seg = {name: prm[i] for i, name in enumerate(sd.PARAM_SEGS)}
        self.r = prm[sd.N_PARAMS - 6]
        self.lit_sel = prm[sd.N_PARAMS - 5]
        self.lo_shift, self.nctx_lo = prm[sd.N_PARAMS - 4], prm[sd.N_PARAMS
                                                                  - 3]
        self.lut0, self.lut1 = sd.LUT0 & 63, sd.LUT1 & 63
        self.weights = [[1, 1, NORM_INIT], [1, 1, NORM_INIT]]
        self.wpos = self.p1 = self.p2 = 0

    def nibble(self, flat: int, cm_flat: int, which: int, cm_speed) -> int:
        sh, r = self.sh, self.r
        mix = sh.combine != 0
        row = sh.model[_gather_row(flat, r)]
        cmr = sh.model[_gather_row(cm_flat, r)]
        w = self.weights[which]
        if mix:
            # lanes 16 + i hold the cm row: each lane's average after one
            # shuffle across the halves
            s = mix_shift(cmr[15], row[15])
            coded = [average((a * row[15]) >> s, (b * cmr[15]) >> s,
                             w[2] & 0xFFFF) for a, b in zip(cmr, row)]
        else:
            coded = row
        state = self.lit.peek()
        v = ballot_sym(coded, state & 0x7FFF)
        start, freq = start_freq_of(lane_divs(coded), v)
        _advance(self.lit, state, start, freq)
        inc, lim = sh.speeds[0]
        new_row = blend_lanes(row, v, inc, lim)
        fw = _scatter_row(flat, r)
        if mix:
            p_cm = start_freq_of(lane_divs(cmr), v)[1]
            p_nib = start_freq_of(lane_divs(row), v)[1]
            update_weights(w, p_cm, p_nib, freq)
            cw = _scatter_row(cm_flat, r)
            if fw >= 0 and fw != cw:
                sh.model[fw] = new_row
            if cw >= 0:
                sh.model[cw] = blend_lanes(cmr, v, *cm_speed)
        elif fw >= 0:
            sh.model[fw] = new_row
        return v

    def run(self, rec) -> None:
        sh, seg = self.sh, self.seg
        if rec[0] == "lit":
            for _ in range(rec[1]):
                sel = (self.lut0[sh.pm_mode, self.p1]
                       | self.lut1[sh.pm_mode, self.p2])
                ctx = sh.lcm[int(sel)]
                if self.lit_sel == 0:
                    ctx_lo = ctx >> self.lo_shift
                    hi, cm_hi = seg["lit_hi"] + ctx, seg["cm_first"] + ctx
                    lo_of = lambda r0: seg["lit_lo"] + ctx_lo * 16 + r0
                    cm_lo_of = lambda r0: (seg["cm_second"]
                                           + r0 * self.nctx_lo + ctx_lo)
                else:
                    hi, cm_hi = seg["lit_hi"] + self.p1, seg["cm_first"] + ctx
                    lo_of = lambda r0: seg["lit_lo"] + self.p1 * 16 + r0
                    cm_lo_of = lambda r0: (seg["cm_second"]
                                           + r0 * self.nctx_lo + ctx)
                r0 = self.nibble(hi, cm_hi, 1, sh.speeds[3])
                v = self.nibble(lo_of(r0), cm_lo_of(r0), 0, sh.speeds[2])
                byte = ((r0 << 4) | v) & 0xFF
                self.window[self.wpos] = byte
                self.p2, self.p1 = self.p1, byte
                self.wpos += 1
        elif rec[0] == "copy":
            n, dist = rec[1], rec[2]
            w_sz = len(self.window)
            done = 0
            while done < n:
                # up to 32 bytes a pass, one a lane: every source byte lies
                # before the pass's first target when the pass is <= dist
                k = min(32, dist, n - done)
                src = [min(max(self.wpos - dist + j, 0), w_sz - 1)
                       for j in range(k)]
                vals = [int(self.window[s]) for s in src]
                for j, x in enumerate(vals):
                    self.window[self.wpos + j] = x
                self.p2 = vals[-2] if k >= 2 else self.p1
                self.p1 = vals[-1]
                self.wpos += k
                done += k


def cmd_records(cmd_states, cmd_words, raw_len, profile: str, lane: int,
                max_steps: int) -> list:
    """The records the cmd warp of one lane pushes (the cmd warp alone:
    no record depends on the literal warp)."""
    prm = [int(x) for x in sd.params(profile)]
    sh = _Shared(prm[sd.N_PARAMS - 6])
    recs = list(_cmd_warp(sh, _Words(cmd_states[lane], cmd_words[lane]),
                          int(raw_len[lane]), prm, (max_steps + 3) & ~3,
                          prm[sd.PARAM_SEGS.index("lit_hi")]))
    return recs


def scan_lanes(cmd_states, cmd_words, lit_states, lit_words, raw_len,
               profile: str, window_size: int, max_steps: int,
               drains: np.ndarray | None = None):
    """(window, ok, wpos) of every lane, as numpy arrays, by the two-warp
    decomposition.  drains: None, or int [B, 2] that takes each lane's
    count of the cmd warp's drains before a header and before a literal
    row (the escape drain)."""
    prm = [int(x) for x in sd.params(profile)]
    lit_base = prm[sd.PARAM_SEGS.index("lit_hi")]
    n_micro = (max_steps + 3) & ~3
    b = len(raw_len)
    window = np.zeros((b, window_size), np.uint8)
    ok = np.zeros(b, bool)
    wpos = np.zeros(b, np.int32)
    for i in range(b):
        sh = _Shared(prm[sd.N_PARAMS - 6])
        lit = _LitWarp(sh, _Words(lit_states[i], lit_words[i]), window[i],
                       prm)
        pending = []
        for rec in _cmd_warp(sh, _Words(cmd_states[i], cmd_words[i]),
                             int(raw_len[i]), prm, n_micro, lit_base):
            if rec[0] == "drain" and drains is not None:
                drains[i, ("header", "row").index(rec[1])] += 1
            if rec[0] in ("drain", "stop"):
                for p in pending:
                    lit.run(p)
                pending = []
                if rec[0] == "stop":
                    ok[i], wpos[i] = rec[1], rec[2]
            elif rec[1] > 0:
                pending.append(rec)
    return window, ok, wpos


# ------------------------------------------------------- the model pass

TILE = 512           # steps a staged tile
OWNERS = 32          # half-warps a block


def owner_of(row: int) -> int:
    return ((row * 0x9E3779B1) & 0xFFFFFFFF) >> 27


def _events(t: np.ndarray):
    """A frame's blend events in step order: (row, v, inc, lim, k, reads
    as the nibble row, reads as the cm row); one event, the cm blend's,
    where the rows coincide."""
    for k, x in enumerate(t.tolist()):
        flat, value, stream, inc, lim, mix, _which, cm_idx, cm_inc, cm_lim = x
        coded = mix != 0 or stream in (0, 1)
        if flat != cm_idx:
            yield flat, value, inc, lim, k, coded, False
            yield cm_idx, value, cm_inc, cm_lim, k, False, mix != 0
        else:
            yield cm_idx, value, cm_inc, cm_lim, k, coded, mix != 0


def _row_chains(t: np.ndarray, num_rows: int):
    """Phase 1: every step's record, [n, 6] (the nibble row's entries
    v - 1, v, 15, then the cm row's; None where no chain wrote), and the
    chain steps each owner ran."""
    n = t.shape[0]
    model = [list(CDF_INIT) for _ in range(num_rows)]
    rec = [[None] * 6 for _ in range(n)]
    cache = [None] * OWNERS     # (row, its entries) a half holds
    ran = [0] * OWNERS
    events = list(_events(t))
    for base in range(0, len(events), 2 * TILE):
        for ev in events[base:base + 2 * TILE]:
            row, v, inc, lim, k, rd_nib, rd_cm = ev
            h = owner_of(row)
            held = cache[h]
            c = held[1] if held is not None and held[0] == row else None
            if inc == 0 and not rd_nib and not rd_cm:
                # a quiet event: skipped when it cannot change its row
                top = c[15] if c is not None else model[row][15]
                if top < lim:
                    continue
            if c is None:
                if held is not None:
                    model[held[0]] = held[1]
                c = list(model[row])
            ran[h] += 1
            for slot, on in ((0, rd_nib), (3, rd_cm)):
                if on:
                    rec[k][slot:slot + 3] = [c[v - 1] if v > 0 else None,
                                             c[v], c[15]]
            cache[h] = (row, blend_lanes(c, v, inc, lim))
    return rec, ran


def model_pass_lanes(traces, num_rows: int, n_lane: int):
    """(starts [2B, n_lane], freqs, counts [2B], chain steps an owner [B,
    32]) by the row chains, the steps in parallel and the weight
    chains."""
    b = len(traces)
    starts = np.zeros((2 * b, n_lane), np.int32)
    freqs = np.ones((2 * b, n_lane), np.int32)
    counts = np.zeros(2 * b, np.int32)
    ran_all = np.zeros((b, OWNERS), np.int64)
    for i, t in enumerate(traces):
        n = t.shape[0]
        rec, ran_all[i] = _row_chains(t, num_rows)
        # phase 2: positions by prefix counts, then each step's output or
        # its mixer's inputs (mixer 0's list from the front of the
        # frame's slots, mixer 1's from the back)
        slots = [None] * n
        carry = [0, 0, 0, 0]
        for k, x in enumerate(t.tolist()):
            value, stream, mix, which = x[1], x[2], x[5], x[6]
            pos = carry[stream] if stream in (0, 1) else 0
            if stream in (0, 1):
                carry[stream] += 1
            nv1, nv, n15, cv1, cv, c15 = ((0 if e is None else e)
                                          for e in rec[k])
            if not mix:
                if stream in (0, 1) and pos < n_lane:
                    r_prev = xdiv(i32(nv1 << 15), n15) if value else 0
                    starts[2 * i + stream, pos] = r_prev + 1
                    freqs[2 * i + stream, pos] = i32(
                        xdiv(i32(nv << 15), n15) - r_prev - 1)
                continue
            q = 2 + which
            e = carry[q] if which == 0 else n - 1 - carry[q]
            carry[q] += 1

            def freq_under(prev, sym, top):
                r_prev = xdiv(i32(prev << 15), top) if value else 0
                return i32(xdiv(i32(sym << 15), top) - r_prev - 1)

            sh = mix_shift(c15, n15)
            a1, b1 = (cv1, nv1) if value else (0, 0)
            slots[e] = ((a1 * n15) >> sh, (b1 * c15) >> sh,
                        (cv * n15) >> sh, (nv * c15) >> sh,
                        (c15 * n15) >> sh, (n15 * c15) >> sh,
                        freq_under(cv1, cv, c15), freq_under(nv1, nv, n15),
                        value, stream, pos)
        counts[2 * i:2 * i + 2] = carry[:2]
        # phase 3: one weight chain a mixer, in its list's order
        for which in (0, 1):
            w = [1, 1, NORM_INIT]
            for j in range(carry[2 + which]):
                e = j if which == 0 else n - 1 - j
                ra0, rb0, ra1, rb1, ra2, rb2, p_cm, p_nib, value, stream, \
                    pos = slots[e]
                rate = w[2] & 0xFFFF
                c_prev = average(ra0, rb0, rate)
                c_sym = average(ra1, rb1, rate)
                maxv = average(ra2, rb2, rate)
                r_prev = xdiv(i32(c_prev << 15), maxv) if value else 0
                st = r_prev + 1
                fr = i32(xdiv(i32(c_sym << 15), maxv) - r_prev - 1)
                if stream in (0, 1) and pos < n_lane:
                    starts[2 * i + stream, pos] = st
                    freqs[2 * i + stream, pos] = fr
                update_weights(w, p_cm, p_nib, fr)
    return starts, freqs, counts, ran_all
