// Adaptive-profile decode scan, for Hopper (sm_90a): the whole command
// FSM of a metablock, one frame a block of two cooperating warps.
//
// Replaces the reference's device program divans_tpu/codec/jax_decode.py:98
// (`decode_scan`, an XLA while_loop, no Pallas kernel).  Contract, per
// frame (lane): its cmd and lit rANS streams (u32 state, u16 words read at
// pos % W, so a corrupt stream wraps) and raw_len; a fresh model of R rows
// of CDF_INIT, weights (1, 1, 2^14), and the FSM's registers at the
// reference's initial values.  One micro-step is jax_decode.body_once for
// one lane: at most one nibble from the cmd or the lit stream, coded
// against the state's row (mixed with the cm row on a literal step of a
// combining lane), or up to COPY_CHUNK = 8 bytes of a copy; then the
// state's transition.  Every select, wrap, clamp and dropped write of
// body_once is kept: a row index outside [0, R) is read as XLA's gather
// reads it (a negative index plus R, then clamped) and written as its
// scatter writes it (a negative index plus R, dropped when still
// outside); a window byte past raw_len is dropped; a copy's source is
// clamped to [0, W - 1].  A lane stops at DONE or ERROR (each a no-op in
// the reference) or after max_steps micro-steps, rounded up to a multiple
// of 4: the reference tests its loop condition every UNROLL = 4
// micro-steps, over all lanes together, and a stopped lane's steps are
// no-ops, so each lane runs exactly that many.  Out: the window, ok =
// (DONE and wpos == raw_len), wpos.  The arithmetic is csrc/
// adaptive.cuh's, exactly the reference's int32.
//
// Design.  A frame's two rANS streams are serial each, but the cmd
// stream never depends on a literal's value or a copied byte: its rows
// follow the command registers alone, and every error test of the FSM
// follows the lengths and wpos.  So a block of 64 threads runs a frame
// on two warps (the split of the upstream codec's two-thread decoder):
//   * the cmd warp decodes the cmd stream (BEGIN, the L_* and C_* length
//     states, the P_* header), tracks wpos from the lengths alone, and
//     numbers every micro-step as the serial FSM would (one a cmd
//     nibble, two a literal byte, one a copy chunk of min(8, nb, dist)
//     bytes).  A literal run or a copy becomes one record of a ring in
//     shared memory, already cut to the bytes it writes before the lane
//     stops (an error, or the micro-step cut inside it), so ok and wpos
//     are the cmd warp's alone;
//   * the literal warp runs the records in order: it decodes the lit
//     stream's byte pairs of nibbles against the L_HI/L_LO rows (mixed
//     with the cm rows where the header set combine), keeps p1, p2 and
//     the weights, and runs each copy 32 bytes a pass (a pattern of
//     `dist` bytes shuffled across the lanes when dist < 32);
//   * the two touch disjoint rows of the one model: the literal rows
//     [lit_hi, R) and the cmd rows below.  The header (pm_mode, the
//     64-entry lcm, the four speeds, combine) is the literal warp's input
//     and the cmd warp's output: at BEGIN v = 7 the cmd warp first
//     drains the ring (waits until the literal warp has run every
//     record), so a header change keeps its place in the order.  A cmd
//     row that reaches the literal rows (C_CS's index after a wrapped
//     length, a corrupt stream only) drains the ring the same way first.
// A row lives one entry a lane (csrc/adaptive_warp.cuh): the literal
// warp's lanes 0-15 hold the nibble row, lanes 16-31 the cm row; the
// average needs one shuffle across the halves, offset -> symbol one
// ballot, and every lane divides its own entry by the row's max before
// the symbol is known (the coded row's, and for the mixer the lane's own
// row's), so (start, freq) and the mixer's two freqs are shuffles after
// it; a division is a multiply by a table's 32-bit reciprocal
// (csrc/adaptive.cuh), norm_weight's 8-bit division a 256-entry table.  A nibble's mixer
// update is applied during the next nibble, which reads the other
// mixer.  The cmd warp holds its row on both halves and keeps each cmd
// row's sixteen quotients in shared memory, refreshed after each blend
// while the transition runs.  The context luts and the model (cm,
// stride) live in shared memory, the mix model in a global slab; each
// stream's words in a register tile of its warp, read a tile ahead; the
// window in global memory (2^18 B a frame does not fit beside the model).
//
// What bounds it.  Per micro-step ~300-600 integer operations and a few
// bytes of words and window; operations bound it on paper.  The real
// limit is the slower of a frame's two warps: the literal warp's ~300
// instructions a nibble (load, average, divisions, ballot, shuffles,
// mixer, blend) or the cmd warp's FSM; a launch takes as long as its
// longest frame, so the frames of a call go in one launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "adaptive.cuh"
#include "adaptive_warp.cuh"

namespace {

using adaptive::kFullMask;

constexpr int kThreads = 64;     // the cmd warp, then the literal warp
constexpr int kCopyChunk = 8;
constexpr int kStateLow = 1 << 15;
constexpr int kRing = 256;       // ring records, a power of two
constexpr int kCmdRows = 256;    // the cmd rows' quotient cache, at most

enum State {
  DONE = 0, BEGIN = 1,
  L_CS = 2, L_BEG = 3, L_LAST = 4, L_MANT = 5, L_HI = 6, L_LO = 7,
  C_CS = 8, C_BEG = 9, C_LAST = 10, C_MANT = 11,
  C_DMN = 12, C_DBEG = 13, C_DLAST = 14, C_DMANT = 15,
  COPY_RUN = 16,
  P_ONLY = 17, P_DCM = 18, P_PD = 19, P_SPD = 20, P_CMN = 21, P_CF = 22,
  P_CS = 23, P_MVMODE = 24,
  ERROR = 25,
};

// params: the segment offsets, then the profile's dimensions, then the
// literal context luts (scan_decode.py: PARAM_NAMES, params())
enum Param {
  S_CC, S_LL_CS, S_LL_BEG, S_LL_LAST, S_LL_MANT, S_LIT_HI, S_LIT_LO,
  S_CM_FIRST, S_CM_SECOND, S_C_CCS, S_C_CBEG, S_C_CLAST, S_C_CMANT,
  S_C_DMN, S_C_DBEG, S_C_DLAST, S_C_DMANT, S_PM_ONLY, S_PM_DCM, S_PM_PD,
  S_PM_PALETTE, S_PM_CMN, S_PM_CF, S_PM_CS, S_PM_MVMODE,
  NUM_ROWS, LIT_SEL, LO_SHIFT, NCTX_LO, NCTX, ND,
  N_PARAMS,
};
constexpr int kLutLen = 4 * 256;

// per-state blend speed (inc, lim); C_DMANT's inc is computed at run time
__constant__ int kSpeed[26][2] = {
    {0, 0},            // DONE
    {0x180, 0x4000},   // BEGIN
    {0x30, 0x4000}, {0x10, 0x2000}, {0x10, 0x2000}, {0x10, 0x2000},
    {0, 0}, {0, 0},    // L_HI, L_LO: the literal speed
    {0x10, 0x2000}, {0x60, 0x4000}, {0x60, 0x4000}, {0x20, 0x1000},
    {0x20, 0x1000}, {0x20, 0x1000}, {0x180, 0x4000}, {0, 0x4000},
    {0, 0},            // COPY_RUN
    {0x30, 0x4000}, {0x30, 0x4000}, {0x60, 0x4000}, {0x60, 0x4000},
    {0x30, 0x4000}, {0x30, 0x4000}, {0x30, 0x4000}, {0x30, 0x4000},
    {0, 0},            // ERROR
};

// each state's segment (its row is the segment's offset plus a term)
__constant__ int kStateSeg[26] = {
    -1, S_CC, S_LL_CS, S_LL_BEG, S_LL_LAST, S_LL_MANT, -1, -1,
    S_C_CCS, S_C_CBEG, S_C_CLAST, S_C_CMANT, S_C_DMN, S_C_DBEG, S_C_DLAST,
    S_C_DMANT, -1, S_PM_ONLY, S_PM_DCM, S_PM_PD, S_PM_PALETTE, S_PM_CMN,
    S_PM_CF, S_PM_CS, S_PM_MVMODE, -1,
};

__device__ __forceinline__ int rum4(int x) { return ((x - 1) | 3) + 1; }

__device__ __forceinline__ int u8_to_speed(int b) {
  const int l = (b >> 3) - 1;
  const int lv = l > 0 ? l : 0;
  return b < 8 ? 0 : ((1 << lv) | (((b & 7) << lv) >> 3));
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// XLA's gather index: a negative index plus R, then clamped to [0, R)
__device__ __forceinline__ int gather_row(int i, int r) {
  const int j = i < 0 ? i + r : i;
  return j < 0 ? 0 : (j >= r ? r - 1 : j);
}

// XLA's scatter index: a negative index plus R; -1 where still outside
__device__ __forceinline__ int scatter_row(int i, int r) {
  const int j = i < 0 ? i + r : i;
  return (j < 0 || j >= r) ? -1 : j;
}

// entry i of four registers (a select chain: no local memory)
__device__ __forceinline__ int pick4(int a0, int a1, int a2, int a3, int i) {
  return i == 0 ? a0 : (i == 1 ? a1 : (i == 2 ? a2 : a3));
}

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void st_volatile(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

// orders a warp's memory operations before a flag it publishes after
// (or after one it read before): the ring's release and acquire
__device__ __forceinline__ void fence_cta() {
  asm volatile("fence.acq_rel.cta;" ::: "memory");
}

// What the two warps of a block share.  The header fields are written by
// the cmd warp only while the ring is drained, and read by the literal
// warp only while it runs a record.
struct Shared {
  int2 ring[kRing];   // (bytes, 0) a literal run, (bytes, dist) a copy,
                      // (-1, 0) the stop
  int head, tail;     // records pushed (cmd warp), records run (literal)
  int lcm[64];
  int speeds[4][2];
  int pm_mode, combine;
  int seg[N_PARAMS];
  int4 state_tab[26];   // each state's (row offset, inc, lim)
  int inv_table[256];
  int cmd_quot[kCmdRows * 16];   // each cmd row's entries' quotients
  uint8_t lut[2][kLutLen];   // the context luts, & 63
};

struct Args {
  const int* cmd_states;
  const int* cmd_words;
  int wc;
  const int* lit_states;
  const int* lit_words;
  int wl;
  const int* raw_lens;
  const int* params;
  int max_steps, win;
  uint8_t* windows;
  uint8_t* ok_out;
  int* wpos_out;
  int16_t* scratch;
  const uint32_t* div_table;
  long long* clocks;
};

// ------------------------------------------------------------ the cmd warp

struct CmdWarp {
  Shared& s;
  int head = 0;          // records pushed
  long long waited = 0;  // cycles spent waiting on the literal warp

  __device__ explicit CmdWarp(Shared& sh) : s(sh) {}

  // one record into the ring, once it has room
  __device__ void push(int n, int dist) {
    if (head - __shfl_sync(kFullMask, ld_volatile(&s.tail), 0) >= kRing) {
      const long long t0 = clock64();
      while (head - __shfl_sync(kFullMask, ld_volatile(&s.tail), 0)
             >= kRing) {
        __nanosleep(64);
      }
      waited += clock64() - t0;
    }
    if (adaptive::lane_id() == 0) {
      s.ring[head & (kRing - 1)] = make_int2(n, dist);
      fence_cta();
      st_volatile(&s.head, head + 1);
    }
    ++head;
    __syncwarp();
  }

  // wait until the literal warp has run every record pushed
  __device__ void drain() {
    const long long t0 = clock64();
    while (__shfl_sync(kFullMask, ld_volatile(&s.tail), 0) != head) {
      __nanosleep(32);
    }
    waited += clock64() - t0;
    fence_cta();
  }
};

__device__ __forceinline__ long long cmd_warp(const Args& a, Shared& s,
                                              int16_t* model, int r, int b) {
  const int lane = adaptive::lane_id();
  const int ent = lane & 15;
  CmdWarp q(s);
  const int lit_base = s.seg[S_LIT_HI];   // <= kCmdRows (checked)
  const int lit_sel = s.seg[LIT_SEL], nctx = s.seg[NCTX], nd = s.seg[ND];
  const int raw_len = a.raw_lens[b];
  const int n_micro = (a.max_steps + 3) & ~3;
  adaptive::WordTile words;
  words.init(a.cmd_words + (size_t)b * a.wc, a.wc);

  int st = BEGIN, m = 0, wpos = 0;
  int cs = a.cmd_states[b], cp = 0;
  int l4s = 3 << 4, llen = 1, clen = 1, dlen = 1, nb = 0, dist = 0;
  int acc = 0, lrem = 0, first = 0, r0 = 0, tmpa = 0, cnt = 0, which = 0;
  int cmidx = 0, aprior = 0;
  int d0 = 4, d1 = 11, d2 = 15, d3 = 16;     // the distance LRU
  int c0 = 0, c1 = 1, c2 = 2, c3 = 3;        // the distance context map
  int lru = lane;                            // cmap_lru[lane], lanes < 13

  while (st != DONE && st != ERROR && m < n_micro) {
    const int avail = n_micro - m;
    const int room = raw_len - wpos;   // >= 0 until an error
    if (st == L_HI) {
      // a literal run of nb bytes (1 when nb <= 0 other than INT_MIN,
      // 2^31 for INT_MIN), two micro-steps a byte; the L_LO at
      // wpos >= raw_len errs and its byte is dropped
      const long long n = nb >= 1 ? (long long)nb
                                  : (nb == INT_MIN ? (1ll << 31) : 1ll);
      if ((long long)room < n && 2 * room + 2 <= avail) {
        if (room > 0) q.push(room, 0);
        wpos = raw_len + 1;
        m += 2 * room + 2;
        st = ERROR;
      } else if (2 * n <= (long long)avail) {
        q.push((int)n, 0);
        wpos += (int)n;
        m += (int)(2 * n);
        nb = (nb >= 1 || nb == INT_MIN) ? 0 : nb - 1;
        st = BEGIN;
      } else {
        const int k = avail >> 1;
        if (k > 0) q.push(k, 0);
        wpos += k;
        m = n_micro;
      }
      continue;
    }
    if (st == COPY_RUN) {
      // chunks of min(8, nb, dist) bytes, one a micro-step; the chunk
      // that passes raw_len errs, writes nothing and advances wpos
      const int c = imin(kCopyChunk, dist);
      const int chunks = (nb - 1) / c + 1;   // nb > 0
      const int err_chunk = nb > room ? room / c : INT_MAX;
      if (err_chunk < avail) {
        if (err_chunk > 0) q.push(err_chunk * c, dist);
        wpos += err_chunk * c + imin(c, nb - err_chunk * c);
        m += err_chunk + 1;
        st = ERROR;
      } else if (chunks <= avail) {
        q.push(nb, dist);
        wpos += nb;
        m += chunks;
        nb = 0;
        st = BEGIN;
      } else {
        q.push(avail * c, dist);
        wpos += avail * c;
        m = n_micro;
      }
      continue;
    }

    // ---- a coded cmd micro-step: the state's row (its segment's offset
    // plus a term of the registers, selected without a branch) and blend
    // speed
    const int fi_c = (clen & 3) + 1;   // clen >= 0: % 4 == & 3
    const int fi_d = (dlen & 3) + 1;
    const int4 sp = s.state_tab[st];
    int term = st == BEGIN ? l4s >> 4 : 0;
    term = st == C_CS
        ? adaptive::wadd((l4s >> 4) & 3,
                         adaptive::wmul(4, imin(adaptive::wadd(llen, -1), 3)))
        : term;
    term = st == C_MANT ? (first != 0 ? fi_c : 0) : term;
    term = st == C_DMN ? aprior * 2 + (llen < 8 ? 1 : 0) : term;
    term = st == C_DBEG ? aprior * 8 + (adaptive::bit_length(nb) >> 2) : term;
    term = st == C_DLAST ? aprior : term;
    term = st == C_DMANT ? aprior * 5 + (first != 0 ? fi_d : 0) : term;
    term = st == P_SPD ? cnt & 3 : term;
    term = (st == P_CMN || st == P_CF || st == P_CS) ? which : term;
    const int flat = adaptive::wadd(sp.x, term);
    int inc = sp.y, lim = sp.z;
    if (st == C_DMANT) {
      inc = first != 0 ? 0x4 << ((fi_d & 6) << ((fi_d & 2) >> 1)) : 0x4;
    }
    const int fr = gather_row(flat, r), fw = scatter_row(flat, r);
    if (fr >= lit_base || fw >= lit_base) q.drain();   // a literal row
    // ---- the rANS peek, the symbol, the advance, the blend
    const int word = words.word(cp);
    int state = cs;
    if (state < kStateLow) {
      state = (int)(((uint32_t)state << 16) | (uint32_t)word);
      ++cp;
      words.advance(cp);
    }
    const int slot = state & (kStateLow - 1);
    const int c = adaptive::load_entry(model, fr);
    const int c15 = model[(size_t)fr * 16 + 15];
    // the row's quotients, kept since its last blend (a literal row, read
    // only after a wrapped length, divides here)
    const int quot = fr < lit_base
        ? s.cmd_quot[fr * 16 + ent]
        : adaptive::scaled(c, adaptive::recip_of(c15, a.div_table));
    const int v = adaptive::ballot_sym(c, c15, slot);
    int start, freq;
    adaptive::lane_start_freq(quot, v, 0, &start, &freq);
    cs = (int)((uint32_t)freq * (uint32_t)(state >> 15) + (uint32_t)slot
               - (uint32_t)start);
    const int nc = adaptive::lane_blend(c, ent, c15, v, inc, lim);
    if (fw >= 0 && lane < 16) adaptive::store_entry(model, fw, nc);
    // the blended row's quotients, needed no sooner than its next use (the
    // divisor's load in flight through the transition)
    const adaptive::Recip next = adaptive::recip_of(
        adaptive::blend_top(c15, inc, lim), a.div_table);
    __syncwarp();
    ++m;

    // =========================== transitions ===========================
    int st2 = st;
    bool err = false;
    bool do_setup = false;
    int setup_d = 0;
    bool do_obs = false;
    int cmap_val = 0;
    const int which_old = which, cmidx_old = cmidx;
    switch (st) {
      case BEGIN:
        if (v == 0xF) {
          st2 = DONE;
          err = wpos != raw_len;
        } else if (v == 3) {
          l4s = ((l4s >> 2) | 128) & 0xFF;
          st2 = L_CS;
          tmpa = 0;
        } else if (v == 1) {
          l4s = ((l4s >> 2) | 64) & 0xFF;
          st2 = C_CS;
        } else if (v == 7) {
          // the header changes the literal warp's state: drain first
          q.drain();
          st2 = P_ONLY;
          lru = lane;
          c0 = 0; c1 = 1; c2 = 2; c3 = 3;
          s.lcm[lane] = 0;
          s.lcm[lane + 32] = 0;
        } else {
          err = true;
        }
        break;
      case L_CS:
        if (v < 14) {
          nb = v + 1;
          llen = v + 1;
          st2 = L_HI;
        } else if (v == 14) {
          st2 = L_BEG;
        } else {   // the high-entropy escape, once
          err = tmpa != 0;
          tmpa = 1;
        }
        break;
      case L_BEG:
        if (v == 15) {
          st2 = L_LAST;
        } else if (v <= 1) {
          nb = 15 + v;
          st2 = L_HI;
        } else {
          lrem = rum4(v - 1);
          acc = 1 << imin(v - 1, 30);
          first = 0;
          st2 = L_MANT;
        }
        break;
      case L_LAST:
        lrem = rum4(v + 14);
        acc = 1 << imin(v + 14, 30);
        err = v + 14 >= 31;
        st2 = L_MANT;
        break;
      case L_MANT: {
        const int nrem = lrem - 4;
        acc = (int)((uint32_t)acc | ((uint32_t)v << imax(nrem, 0)));
        lrem = nrem;
        if (nrem == 0) {
          nb = adaptive::wadd(acc, 15);
          llen = nb;
          st2 = L_HI;
        }
        break;
      }
      case C_CS:
        if (v < 15) {
          nb = v;
          clen = adaptive::bit_length(v);
          st2 = C_DMN;
        } else {
          st2 = C_BEG;
        }
        break;
      case C_BEG:
        if (v == 15) {
          st2 = C_LAST;
        } else {
          clen = v + 4;
          lrem = rum4(v + 3);
          acc = 1 << imin(v + 3, 30);
          first = 1;
          st2 = C_MANT;
        }
        break;
      case C_LAST:
        clen = v + 19;
        lrem = rum4(v + 18);
        acc = 1 << imin(v + 18, 30);
        err = v + 18 >= 31;
        first = 1;
        st2 = C_MANT;
        break;
      case C_MANT: {
        const int nrem = lrem - 4;
        acc = (int)((uint32_t)acc | ((uint32_t)v << imax(nrem, 0)));
        lrem = nrem;
        first = 0;
        if (nrem == 0) {
          nb = acc;
          st2 = C_DMN;
        }
        break;
      }
      case C_DMN:
        if (v == 15) {
          st2 = C_DBEG;
        } else {
          const bool lt4 = v < 4;
          const int u = v >> 2;
          const int d_calc = adaptive::wadd((v & 2) != 0 ? d1 : d0,
                                            (v & 1) != 0 ? -u : u);
          const int d_mn = lt4 ? pick4(d0, d1, d2, d3, v) : d_calc;
          err = !lt4 && d_calc <= 0;
          dlen = adaptive::bit_length(imax(d_mn, 0));
          do_setup = true;
          setup_d = d_mn;
        }
        break;
      case C_DBEG:
        if (v == 15) {
          const int d15 = adaptive::wadd(d1, -3);
          dlen = adaptive::bit_length(imax(d15, 0));
          do_setup = true;
          setup_d = d15;
        } else if (v == 14) {
          st2 = C_DLAST;
        } else if (v == 0) {
          dlen = 1;
          do_setup = true;
          setup_d = 1;
        } else {
          dlen = v + 1;
          lrem = rum4(v);
          acc = 1 << imin(v, 30);
          first = 1;
          st2 = C_DMANT;
        }
        break;
      case C_DLAST:
        dlen = v + 15;
        lrem = rum4(v + 14);
        acc = 1 << imin(v + 14, 30);
        first = 1;
        st2 = C_DMANT;
        break;
      case C_DMANT: {
        const int nrem = lrem - 4;
        acc = (int)((uint32_t)acc | ((uint32_t)v << imax(nrem, 0)));
        lrem = nrem;
        first = 0;
        if (nrem == 0) {
          do_setup = true;
          setup_d = acc;
        }
        break;
      }
      case P_ONLY:
        err = v > 3;
        if (lane == 0) s.pm_mode = imin(v, 3);
        st2 = P_DCM;
        break;
      case P_DCM:
        if (lane == 0) s.combine = (v & 3) != 0;
        st2 = P_PD;
        break;
      case P_PD:
        cnt = 0;
        st2 = P_SPD;
        break;
      case P_SPD: {
        const int pt = cnt & 3;
        if (pt == 0) tmpa = v << 3;
        if (pt == 1) tmpa = tmpa | v;
        if (pt == 2) r0 = v << 3;
        if (pt == 3) {
          r0 = r0 | v;
          if (lane == 0) {
            s.speeds[cnt >> 2][0] = u8_to_speed(tmpa);
            s.speeds[cnt >> 2][1] = u8_to_speed(r0);
          }
        }
        if (cnt == 15) {
          which = 0;
          cmidx = 0;
          st2 = P_CMN;
        }
        ++cnt;
        break;
      }
      case P_CMN:
        if (v == 14) {
          if (which_old == 0) {
            lru = lane;
            which = 1;
            cmidx = 0;
          } else {
            st2 = P_MVMODE;
          }
        } else if (v == 15) {
          st2 = P_CF;
        } else if (v == 13) {
          cmap_val = (__reduce_max_sync(kFullMask, lane < 13 ? lru : INT_MIN)
                      + 1) & 0xFF;
          do_obs = true;
        } else {
          cmap_val = __shfl_sync(kFullMask, lru, v);
          do_obs = true;
        }
        break;
      case P_CF:
        tmpa = v << 4;
        st2 = P_CS;
        break;
      case P_CS:
        cmap_val = tmpa | v;
        do_obs = true;
        st2 = P_CMN;
        break;
      case P_MVMODE:
        err = v != (lit_sel == 0 ? 0 : 1);
        st2 = BEGIN;
        break;
      default:
        break;
    }

    // entering C_DMN: the distance prior
    if (st2 == C_DMN && st != C_DMN) {
      aprior = pick4(c0, c1, c2, c3, imin(imax(nb, 2) - 2, 3));
    }

    // copy setup: validate the distance, update the LRU, start the run
    if (do_setup) {
      err = err || setup_d <= 0 || setup_d > wpos;
      const int l0 = d0, l1 = d1, l2 = d2, l3 = d3;
      if (setup_d == l1) {
        d0 = setup_d; d1 = l0; d2 = l2; d3 = l3;
      } else if (setup_d == l2) {
        d0 = setup_d; d1 = l0; d2 = l1; d3 = l3;
      } else if (setup_d != l0) {
        d0 = setup_d; d1 = l0; d2 = l1; d3 = l2;
      }
      dist = setup_d;
      st2 = nb > 0 ? COPY_RUN : BEGIN;
    }

    // a context-map value: move to the front of the LRU (lane i holds
    // entry i), store in the map
    if (do_obs) {
      const unsigned hit = __ballot_sync(kFullMask, lane < 13
                                                        && lru == cmap_val);
      const int end = hit != 0 ? __ffs(hit) - 1 : 12;
      const int up = __shfl_up_sync(kFullMask, lru, 1);
      if (lane == 0) {
        lru = cmap_val;
      } else if (lane <= end) {
        lru = up;
      }
      if (which_old == 0) {
        err = err || cmidx_old >= 64 || cmap_val >= nctx;
        if (cmidx_old < 64 && lane == 0) s.lcm[cmidx_old] = cmap_val;
      } else {
        err = err || cmidx_old >= 4 || cmap_val >= nd;
        if (cmidx_old < 4) {
          c0 = cmidx_old == 0 ? cmap_val : c0;
          c1 = cmidx_old == 1 ? cmap_val : c1;
          c2 = cmidx_old == 2 ? cmap_val : c2;
          c3 = cmidx_old == 3 ? cmap_val : c3;
        }
      }
      cmidx = cmidx_old + 1;
    }
    if (fw >= 0 && fw < lit_base && lane < 16) {
      s.cmd_quot[fw * 16 + ent] = adaptive::scaled(nc, next);
    }
    __syncwarp();
    st = err ? ERROR : st2;
  }
  q.push(-1, 0);
  if (lane == 0) {
    a.ok_out[b] = (st == DONE && wpos == raw_len) ? 1 : 0;
    a.wpos_out[b] = wpos;
  }
  return q.waited;
}

// -------------------------------------------------------- the literal warp

struct LitWarp {
  const Shared& s;
  int16_t* model;
  const uint32_t* div_table;
  int r;
  int lane, ent, upper;
  adaptive::WordTile words;
  int ls, lp;
  // the mixers: L_LO's weights[0] and L_HI's weights[1]
  int lo_w0 = 1, lo_w1 = 1, lo_w2 = adaptive::kNormWeightInit;
  int hi_w0 = 1, hi_w1 = 1, hi_w2 = adaptive::kNormWeightInit;
  // the last nibble's mixer update (its freqs under the cm, nibble and
  // coded rows), applied during the next nibble: its weights are read
  // again only a nibble later
  int up_cm = 0, up_nib = 0, up_freq = 0;
  bool up_on = false;
  // the header, read at each record
  int combine, inc, lim;

  __device__ LitWarp(const Shared& sh, int16_t* m, const uint32_t* table,
                     int rows)
      : s(sh), model(m), div_table(table), r(rows) {
    lane = adaptive::lane_id();
    ent = lane & 15;
    upper = lane >> 4;
  }

  // the pending update into weights (w0, w1, w2), without a branch
  __device__ __forceinline__ void apply(int& w0, int& w1, int& w2) {
    int n0 = w0, n1 = w1, n2 = w2;
    adaptive::update_weights(n0, n1, n2, up_cm, up_nib, up_freq,
                             s.inv_table);
    const bool on = combine && up_on;
    w0 = on ? n0 : w0;
    w1 = on ? n1 : w1;
    w2 = on ? n2 : w2;
  }

  // one nibble of the lit stream against row `flat` (lanes 0-15) mixed
  // with cm row `cm_flat` (lanes 16-31) under the weights of L_HI (kHi)
  // or L_LO, when combining; both rows blended after (the cm row with
  // cm_inc, cm_lim).  The other mixer takes the last nibble's update.
  template <bool kHi>
  __device__ int nibble(int flat, int cm_flat, int cm_inc, int cm_lim) {
    const int fr = gather_row(flat, r), cr = gather_row(cm_flat, r);
    const int mine = upper ? cr : fr;
    const int own = adaptive::load_entry(model, mine);
    const int own15 = model[(size_t)mine * 16 + 15];
    if (kHi) {
      apply(lo_w0, lo_w1, lo_w2);
    } else {
      apply(hi_w0, hi_w1, hi_w2);
    }
    const int rate = (kHi ? hi_w2 : lo_w2) & 0xFFFF;
    const int other = __shfl_xor_sync(kFullMask, own, 16);
    const int other15 = __shfl_xor_sync(kFullMask, own15, 16);
    const int rowv = upper ? other : own, row15 = upper ? other15 : own15;
    const int cmv = upper ? own : other, cm15 = upper ? own15 : other15;
    const adaptive::Mix mx = adaptive::mix_of(cm15, row15, rate);
    const int coded = combine ? adaptive::average(mx, cmv, rowv) : rowv;
    const int coded15 = combine ? adaptive::average(mx, cm15, row15) : row15;
    // every lane's quotients before the symbol is known: the coded row's
    // and, for the mixer, its own row's
    const int q_coded = adaptive::scaled(
        coded, adaptive::recip_of(coded15, div_table));
    const int q_own = adaptive::scaled(own,
                                       adaptive::recip_of(own15, div_table));
    const int word = words.word(lp);
    int state = ls;
    if (state < kStateLow) {
      state = (int)(((uint32_t)state << 16) | (uint32_t)word);
      ++lp;
      words.advance(lp);
    }
    const int slot = state & (kStateLow - 1);
    const int v = adaptive::ballot_sym(coded, coded15, slot);
    int start, freq;
    adaptive::lane_start_freq(q_coded, v, 0, &start, &freq);
    ls = (int)((uint32_t)freq * (uint32_t)(state >> 15) + (uint32_t)slot
               - (uint32_t)start);
    int p_nib_start, p_cm_start;
    adaptive::lane_start_freq(q_own, v, 0, &p_nib_start, &up_nib);
    adaptive::lane_start_freq(q_own, v, 16, &p_cm_start, &up_cm);
    up_freq = freq;
    up_on = true;
    const int fw = scatter_row(flat, r), cw = scatter_row(cm_flat, r);
    const int nv = upper ? adaptive::lane_blend(own, ent, own15, v, cm_inc,
                                                cm_lim)
                         : adaptive::lane_blend(own, ent, own15, v, inc, lim);
    if (!upper) {
      // where the two rows coincide the cm row's blend is the one kept
      if (fw >= 0 && !(combine && fw == cw)) {
        adaptive::store_entry(model, fw, nv);
      }
    } else if (combine && cw >= 0) {
      adaptive::store_entry(model, cw, nv);
    }
    __syncwarp();
    return v;
  }

  // the run's last update (an L_LO nibble's), before the header changes
  __device__ void flush() {
    apply(lo_w0, lo_w1, lo_w2);
    up_on = false;
  }
};

__device__ __forceinline__ long long lit_warp(const Args& a, Shared& s,
                                              int16_t* model, int r, int b) {
  LitWarp L(s, model, a.div_table, r);
  const int lane = L.lane;
  const int* seg = s.seg;
  const int lit_sel = seg[LIT_SEL], lo_shift = seg[LO_SHIFT];
  const int nctx_lo = seg[NCTX_LO];
  L.words.init(a.lit_words + (size_t)b * a.wl, a.wl);
  L.ls = a.lit_states[b];
  L.lp = 0;
  uint8_t* window = a.windows + (size_t)b * a.win;
  const int win = a.win;
  int wpos = 0, p1 = 0, p2 = 0;   // p1, p2: window[wpos - 1], [wpos - 2]
  int tail = 0;
  long long waited = 0;   // cycles spent waiting on the cmd warp
  while (true) {
    if (__shfl_sync(kFullMask, ld_volatile(&s.head), 0) == tail) {
      const long long t0 = clock64();
      while (__shfl_sync(kFullMask, ld_volatile(&s.head), 0) == tail) {
        __nanosleep(32);
      }
      waited += clock64() - t0;
    }
    fence_cta();
    const int2 rec = s.ring[tail & (kRing - 1)];
    if (rec.x < 0) break;
    const int n = rec.x, dist = rec.y;
    if (dist == 0) {
      // a literal run: n bytes, each an L_HI and an L_LO nibble
      const int pm = s.pm_mode;
      L.combine = s.combine;
      L.inc = s.speeds[0][0];
      L.lim = s.speeds[0][1];
      const int hi_inc = s.speeds[3][0], hi_lim = s.speeds[3][1];
      const int lo_inc = s.speeds[2][0], lo_lim = s.speeds[2][1];
      const uint8_t* lut0 = s.lut[0] + pm * 256;
      const uint8_t* lut1 = s.lut[1] + pm * 256;
      for (int j = 0; j < n; ++j) {
        const int ctx = s.lcm[lut0[p1] | lut1[p2]];
        int hi_flat, cm_hi, lo_base, cm_lo_base;
        if (lit_sel == 0) {
          const int ctx_lo = ctx >> lo_shift;
          hi_flat = seg[S_LIT_HI] + ctx;
          lo_base = seg[S_LIT_LO] + ctx_lo * 16;
          cm_hi = seg[S_CM_FIRST] + ctx;
          cm_lo_base = seg[S_CM_SECOND] + ctx_lo;
        } else {
          hi_flat = seg[S_LIT_HI] + p1;
          lo_base = seg[S_LIT_LO] + p1 * 16;
          cm_hi = seg[S_CM_FIRST] + ctx;
          cm_lo_base = seg[S_CM_SECOND] + ctx;
        }
        const int r0 = L.nibble<true>(hi_flat, cm_hi, hi_inc, hi_lim);
        const int v = L.nibble<false>(lo_base + r0,
                                      cm_lo_base + r0 * nctx_lo, lo_inc,
                                      lo_lim);
        const int byte = ((r0 << 4) | v) & 0xFF;
        if (lane == 0 && wpos < win) window[wpos] = (uint8_t)byte;
        p2 = p1;
        p1 = byte;
        ++wpos;
      }
      L.flush();
    } else {
      // a copy of n bytes from dist back, 32 a pass, one a lane: with
      // dist >= 32 a pass reads only bytes before it; below 32 the copy
      // repeats its first dist bytes, read once (dist <= wpos, so no
      // source is clamped)
      __syncwarp();
      const bool short_dist = dist < 32;
      int pattern = 0;
      if (short_dist && lane < dist) {
        int src = wpos - dist + lane;
        src = src < 0 ? 0 : (src > win - 1 ? win - 1 : src);
        pattern = window[src];
      }
      for (int done = 0; done < n;) {
        const int k = imin(32, n - done);
        int val = 0;
        if (short_dist) {
          val = __shfl_sync(kFullMask, pattern, (done + lane) % dist);
        } else if (lane < k) {
          int src = wpos - dist + lane;
          src = src < 0 ? 0 : (src > win - 1 ? win - 1 : src);
          val = window[src];
        }
        if (lane < k && wpos + lane < win) window[wpos + lane] = (uint8_t)val;
        __syncwarp();
        const int last = __shfl_sync(kFullMask, val, k - 1);
        const int prev = __shfl_sync(kFullMask, val, k >= 2 ? k - 2 : 0);
        p2 = k >= 2 ? prev : p1;
        p1 = last;
        wpos += k;
        done += k;
      }
    }
    __syncwarp();
    fence_cta();
    if (lane == 0) st_volatile(&s.tail, tail + 1);
    ++tail;
  }
  return waited;
}

// kSlab: the model in the global scratch slab, else in shared memory
template <bool kSlab>
__global__ void __launch_bounds__(kThreads) scan_kernel(Args a) {
  extern __shared__ int4 smem[];
  __shared__ Shared s;
  const int b = blockIdx.x;
  const int r = a.params[NUM_ROWS];
  int16_t* model = kSlab ? a.scratch + (size_t)b * r * 16
                         : reinterpret_cast<int16_t*>(smem);
  adaptive::fill_model(model, r);
  for (int i = threadIdx.x; i < 64; i += kThreads) s.lcm[i] = 0;
  for (int i = threadIdx.x; i < N_PARAMS; i += kThreads) {
    s.seg[i] = a.params[i];
  }
  for (int i = threadIdx.x; i < 2 * kLutLen; i += kThreads) {
    s.lut[i / kLutLen][i % kLutLen] = (uint8_t)(a.params[N_PARAMS + i] & 63);
  }
  adaptive::init_inv_table(s.inv_table);
  // CDF_INIT's quotients: (4 (i + 1) << 15) / 64 = (i + 1) << 11
  for (int i = threadIdx.x; i < kCmdRows * 16; i += kThreads) {
    s.cmd_quot[i] = ((i & 15) + 1) << 11;
  }
  if (threadIdx.x < 26) {
    const int sg = kStateSeg[threadIdx.x];
    s.state_tab[threadIdx.x] = make_int4(sg >= 0 ? a.params[sg] : 0,
                                         kSpeed[threadIdx.x][0],
                                         kSpeed[threadIdx.x][1], 0);
  }
  if (threadIdx.x < 4) {
    s.speeds[threadIdx.x][0] = 0x10;
    s.speeds[threadIdx.x][1] = 0x2000;
  }
  if (threadIdx.x == 0) {
    s.pm_mode = 3;
    s.combine = 0;
    s.head = 0;
    s.tail = 0;
  }
  __syncthreads();
  const long long t0 = clock64();
  const long long waited = threadIdx.x < 32 ? cmd_warp(a, s, model, r, b)
                                            : lit_warp(a, s, model, r, b);
  if (a.clocks != nullptr && (threadIdx.x & 31) == 0) {
    const int w = threadIdx.x >> 5;
    a.clocks[4 * b + w] = clock64() - t0;
    a.clocks[4 * b + 2 + w] = waited;
  }
}

}  // namespace

extern "C" int dtpu_scan_decode_max_shared() {
  return adaptive::kMaxShared;
}

extern "C" int dtpu_scan_decode_n_params() { return N_PARAMS; }

// cmd_states, lit_states int32 [B]; cmd_words int32 [B, wc], lit_words
// int32 [B, wl] (u16 values; wc, wl powers of two); raw_len int32 [B];
// params int32 [N_PARAMS + 2048] -> windows uint8 [B, win] (zeroed by the
// caller), ok uint8 [B], wpos int32 [B].  scratch: int16 [B, R, 16] when R
// x 32 B exceeds the shared limit, else null.  div_table: uint32
// [32769], the reciprocals of adaptive.cuh's Recip.  clocks:
// null, or int64
// [B, 4]: each frame's cmd-warp and literal-warp finish times in SM
// cycles (clock64) from the block's start, then the cycles each waited
// on the other.  Returns cudaGetLastError()
// after the launch.
extern "C" int dtpu_scan_decode(const void* cmd_states, const void* cmd_words,
                                int wc, const void* lit_states,
                                const void* lit_words, int wl,
                                const void* raw_len, const void* params,
                                int num_rows, int max_steps, int win, int b,
                                void* windows, void* ok, void* wpos,
                                void* scratch, const void* div_table,
                                void* clocks, void* stream) {
  const bool slab = scratch != nullptr;
  size_t smem;
  const cudaError_t e = slab
      ? adaptive::model_smem(scan_kernel<true>, num_rows, true, 0, &smem)
      : adaptive::model_smem(scan_kernel<false>, num_rows, false, 0, &smem);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.cmd_states = static_cast<const int*>(cmd_states);
  a.cmd_words = static_cast<const int*>(cmd_words);
  a.wc = wc;
  a.lit_states = static_cast<const int*>(lit_states);
  a.lit_words = static_cast<const int*>(lit_words);
  a.wl = wl;
  a.raw_lens = static_cast<const int*>(raw_len);
  a.params = static_cast<const int*>(params);
  a.max_steps = max_steps;
  a.win = win;
  a.windows = static_cast<uint8_t*>(windows);
  a.ok_out = static_cast<uint8_t*>(ok);
  a.wpos_out = static_cast<int*>(wpos);
  a.scratch = static_cast<int16_t*>(scratch);
  a.div_table = static_cast<const uint32_t*>(div_table);
  a.clocks = static_cast<long long*>(clocks);
  if (slab) {
    scan_kernel<true><<<b, kThreads, smem, (cudaStream_t)stream>>>(a);
  } else {
    scan_kernel<false><<<b, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
