// Adaptive-profile decode scan, for Hopper (sm_90a): the whole command
// FSM of a metablock, one frame a thread.
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
// Design.  One block of 32 threads per frame: they fill the model with
// CDF_INIT, then thread 0 runs the frame's micro-steps as a switch on the
// state.  The model lives in shared memory where R x 32 B fits a block
// (cm 2,379 rows, 76,128 B; stride 4,572, 146,304 B), else in a global
// scratch slab (mix); the context maps, LRUs, speeds and weights in
// static shared memory; the window in global memory, the last two bytes
// also in registers (a live lane's window holds exactly its output, so
// they are window[wpos - 1] and window[wpos - 2]).  Each stream's next
// word is loaded at the top of a micro-step, ahead of its use.
//
// What bounds it.  Per micro-step ~300-600 integer operations (the row
// loads, 15 compares, up to six floor divisions, 16-entry blends, on a
// mixed literal 16 averages and the mixer update) and a few bytes of
// words and window; operations bound it on paper.  The real limit is the
// serial chain of a frame, one micro-step after another in one thread; a
// launch takes as long as its longest frame, so the frames of a call go
// in one launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "adaptive.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kCopyChunk = 8;
constexpr int kStateLow = 1 << 15;

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

// per-state blend speed (inc, lim); C_DMANT's is computed at run time
__constant__ int kSpeed[26][2] = {
    {0, 0},            // DONE
    {0x180, 0x4000},   // BEGIN
    {0x30, 0x4000}, {0x10, 0x2000}, {0x10, 0x2000}, {0x10, 0x2000},
    {0, 0}, {0, 0},    // L_HI, L_LO: the literal speed
    {0x10, 0x2000}, {0x60, 0x4000}, {0x60, 0x4000}, {0x20, 0x1000},
    {0x20, 0x1000}, {0x20, 0x1000}, {0x180, 0x4000}, {0, 0},
    {0, 0},            // COPY_RUN
    {0x30, 0x4000}, {0x30, 0x4000}, {0x60, 0x4000}, {0x60, 0x4000},
    {0x30, 0x4000}, {0x30, 0x4000}, {0x30, 0x4000}, {0x30, 0x4000},
    {0, 0},            // ERROR
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

__global__ void __launch_bounds__(kThreads) scan_kernel(
    const int* __restrict__ cmd_states, const int* __restrict__ cmd_words,
    int wc, const int* __restrict__ lit_states,
    const int* __restrict__ lit_words, int wl,
    const int* __restrict__ raw_lens, const int* __restrict__ params,
    int max_steps, int win, uint8_t* __restrict__ windows,
    uint8_t* __restrict__ ok_out, int* __restrict__ wpos_out,
    int16_t* __restrict__ scratch) {
  extern __shared__ int4 smem[];
  __shared__ int lcm[64], dcm[4], cmap_lru[13], dlru[4], speeds[4][2];
  __shared__ int weights[2][3];
  const int b = blockIdx.x;
  const int r = params[NUM_ROWS];
  int16_t* model = adaptive::init_model(smem, scratch, b, r);
  for (int i = threadIdx.x; i < 64; i += kThreads) lcm[i] = 0;
  if (threadIdx.x < 4) {
    dcm[threadIdx.x] = threadIdx.x;
    const int init_lru[4] = {4, 11, 15, 16};
    dlru[threadIdx.x] = init_lru[threadIdx.x];
    speeds[threadIdx.x][0] = 0x10;
    speeds[threadIdx.x][1] = 0x2000;
  }
  if (threadIdx.x < 13) cmap_lru[threadIdx.x] = threadIdx.x;
  adaptive::init_weights(weights);
  __syncthreads();
  if (threadIdx.x != 0) return;

  int seg[S_PM_MVMODE + 1];
#pragma unroll
  for (int i = 0; i <= S_PM_MVMODE; ++i) seg[i] = params[i];
  const int lit_sel = params[LIT_SEL], lo_shift = params[LO_SHIFT];
  const int nctx_lo = params[NCTX_LO], nctx = params[NCTX];
  const int nd = params[ND];
  const int* lut0 = params + N_PARAMS;
  const int* lut1 = lut0 + kLutLen;
  const int* cwords = cmd_words + (size_t)b * wc;
  const int* lwords = lit_words + (size_t)b * wl;
  uint8_t* window = windows + (size_t)b * win;
  const int raw_len = raw_lens[b];

  int st = BEGIN;
  int cs = cmd_states[b], cp = 0, ls = lit_states[b], lp = 0;
  int wpos = 0, p1 = 0, p2 = 0;   // p1, p2: window[wpos - 1], [wpos - 2]
  int l4s = 3 << 4, llen = 1, clen = 1, dlen = 1, nb = 0, dist = 0;
  int acc = 0, lrem = 0, first = 0, r0 = 0, tmpa = 0, cnt = 0, which = 0;
  int cmidx = 0, aprior = 0, pm_mode = 3, combine = 0;
  const int n_micro = (max_steps + 3) & ~3;

  for (int step = 0; step < n_micro && st != DONE && st != ERROR; ++step) {
    const int wc_next = cwords[cp % wc];
    const int wl_next = lwords[lp % wl];
    const bool use_lit = st == L_HI || st == L_LO;
    const bool nocode = st == COPY_RUN;   // DONE and ERROR never get here
    int v = 0;
    if (!nocode) {
      // ---- the literal context (L_HI, L_LO)
      const int selected = lut0[pm_mode * 256 + p1] | lut1[pm_mode * 256 + p2];
      const int ctx = lcm[selected & 63];
      int hi_flat, lo_flat, cm_hi, cm_lo;
      if (lit_sel == 0) {
        const int ctx_lo = ctx >> lo_shift;
        hi_flat = seg[S_LIT_HI] + ctx;
        lo_flat = seg[S_LIT_LO] + ctx_lo * 16 + r0;
        cm_hi = seg[S_CM_FIRST] + ctx;
        cm_lo = seg[S_CM_SECOND] + r0 * nctx_lo + ctx_lo;
      } else {
        hi_flat = seg[S_LIT_HI] + p1;
        lo_flat = seg[S_LIT_LO] + p1 * 16 + r0;
        cm_hi = seg[S_CM_FIRST] + ctx;
        cm_lo = seg[S_CM_SECOND] + r0 * nctx_lo + ctx;
      }
      // ---- the state's row and blend speed
      const int fi_c = (clen & 3) + 1;   // clen >= 0: % 4 == & 3
      const int fi_d = (dlen & 3) + 1;
      int flat = 0;
      switch (st) {
        case BEGIN: flat = seg[S_CC] + (l4s >> 4); break;
        case L_CS: flat = seg[S_LL_CS]; break;
        case L_BEG: flat = seg[S_LL_BEG]; break;
        case L_LAST: flat = seg[S_LL_LAST]; break;
        case L_MANT: flat = seg[S_LL_MANT]; break;
        case L_HI: flat = hi_flat; break;
        case L_LO: flat = lo_flat; break;
        case C_CS:
          flat = adaptive::wadd(seg[S_C_CCS] + ((l4s >> 4) & 3),
                                adaptive::wmul(4, imin(adaptive::wadd(llen, -1), 3)));
          break;
        case C_BEG: flat = seg[S_C_CBEG]; break;
        case C_LAST: flat = seg[S_C_CLAST]; break;
        case C_MANT: flat = seg[S_C_CMANT] + (first != 0 ? fi_c : 0); break;
        case C_DMN: flat = seg[S_C_DMN] + aprior * 2 + (llen < 8 ? 1 : 0);
          break;
        case C_DBEG:
          flat = seg[S_C_DBEG] + aprior * 8 + (adaptive::bit_length(nb) >> 2);
          break;
        case C_DLAST: flat = seg[S_C_DLAST] + aprior; break;
        case C_DMANT:
          flat = seg[S_C_DMANT] + aprior * 5 + (first != 0 ? fi_d : 0);
          break;
        case P_ONLY: flat = seg[S_PM_ONLY]; break;
        case P_DCM: flat = seg[S_PM_DCM]; break;
        case P_PD: flat = seg[S_PM_PD]; break;
        case P_SPD: flat = seg[S_PM_PALETTE] + (cnt & 3); break;
        case P_CMN: flat = seg[S_PM_CMN] + which; break;
        case P_CF: flat = seg[S_PM_CF] + which; break;
        case P_CS: flat = seg[S_PM_CS] + which; break;
        case P_MVMODE: flat = seg[S_PM_MVMODE]; break;
        default: break;
      }
      int inc = kSpeed[st][0], lim = kSpeed[st][1];
      if (use_lit) {
        inc = speeds[0][0];
        lim = speeds[0][1];
      }
      if (st == C_DMANT) {
        inc = first != 0 ? 0x4 << ((fi_d & 6) << ((fi_d & 2) >> 1)) : 0x4;
        lim = 0x4000;
      }
      // ---- the rANS peek
      int state = use_lit ? ls : cs;
      if (state < kStateLow) {
        state = (int)(((uint32_t)state << 16) | (uint32_t)(use_lit ? wl_next
                                                                   : wc_next));
        if (use_lit) {
          ++lp;
        } else {
          ++cp;
        }
      }
      const int slot = state & (kStateLow - 1);
      // ---- the rows, the symbol, the advance, the mixer, the blends
      const int flat_r = gather_row(flat, r);
      const int cm_flat = st == L_HI ? cm_hi : (st == L_LO ? cm_lo : 0);
      const int cm_r = gather_row(cm_flat, r);
      int row[16], cmr[16], coded[16];
      adaptive::load_row(model, flat_r, row);
      adaptive::load_row(model, cm_r, cmr);
      const bool do_mix = use_lit && combine != 0;
      int* w = weights[st == L_HI ? 1 : 0];
      if (do_mix) {
        const adaptive::Mix m = adaptive::mix_of(cmr[15], row[15],
                                                 w[2] & 0xFFFF);
#pragma unroll
        for (int i = 0; i < 16; ++i) coded[i] = adaptive::average(m, cmr[i], row[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) coded[i] = row[i];
      }
      v = adaptive::offset_to_sym(coded, slot);
      int start, freq;
      adaptive::start_freq(adaptive::pick(coded, v - 1),
                           adaptive::pick(coded, v), coded[15], v, &start,
                           &freq);
      const int adv = (int)((uint32_t)freq * (uint32_t)(state >> 15)
                            + (uint32_t)slot - (uint32_t)start);
      if (use_lit) {
        ls = adv;
      } else {
        cs = adv;
      }
      if (do_mix) {
        adaptive::update_weights(w, adaptive::freq_of(cmr, v),
                                 adaptive::freq_of(row, v), freq);
      }
      adaptive::blend(row, v, inc, lim);
      const int flat_w = scatter_row(flat, r);
      if (flat_w >= 0) adaptive::store_row(model, flat_w, row);
      if (do_mix) {
        const int* cm_sp = speeds[st == L_HI ? 3 : 2];
        adaptive::blend(cmr, v, cm_sp[0], cm_sp[1]);
        const int cm_w = scatter_row(cm_flat, r);
        if (cm_w >= 0) adaptive::store_row(model, cm_w, cmr);
      }
    }

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
          st2 = P_ONLY;
          for (int i = 0; i < 13; ++i) cmap_lru[i] = i;
          for (int i = 0; i < 4; ++i) dcm[i] = i;
          for (int i = 0; i < 64; ++i) lcm[i] = 0;
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
      case L_HI:
        r0 = v;
        st2 = L_LO;
        break;
      case L_LO: {
        err = wpos >= raw_len;
        const int byte = ((r0 << 4) | v) & 0xFF;
        if (wpos < raw_len && wpos < win) window[wpos] = (uint8_t)byte;
        p2 = p1;
        p1 = byte;
        ++wpos;
        nb = adaptive::wadd(nb, -1);
        st2 = nb > 0 ? L_HI : BEGIN;
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
          const int d_calc = adaptive::wadd(dlru[(v & 2) >> 1],
                                            (v & 1) != 0 ? -u : u);
          const int d_mn = lt4 ? dlru[imin(v, 3)] : d_calc;
          err = !lt4 && d_calc <= 0;
          dlen = adaptive::bit_length(imax(d_mn, 0));
          do_setup = true;
          setup_d = d_mn;
        }
        break;
      case C_DBEG:
        if (v == 15) {
          const int d15 = adaptive::wadd(dlru[1], -3);
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
      case COPY_RUN: {
        const int k = imin(imin(kCopyChunk, nb), dist);
        err = wpos + k > raw_len;
        if (wpos + k <= raw_len) {
          uint8_t vals[kCopyChunk];
          for (int o = 0; o < k; ++o) {
            int src = wpos - dist + o;
            src = src < 0 ? 0 : (src > win - 1 ? win - 1 : src);
            vals[o] = window[src];
          }
          for (int o = 0; o < k; ++o) {
            if (wpos + o < win) window[wpos + o] = vals[o];
          }
          p2 = k >= 2 ? vals[k - 2] : p1;
          p1 = vals[k - 1];
        }
        wpos += k;
        nb -= k;
        st2 = nb > 0 ? COPY_RUN : BEGIN;
        break;
      }
      case P_ONLY:
        err = v > 3;
        pm_mode = imin(v, 3);
        st2 = P_DCM;
        break;
      case P_DCM:
        combine = (v & 3) != 0;
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
          const int si = cnt >> 2;
          speeds[si][0] = u8_to_speed(tmpa);
          speeds[si][1] = u8_to_speed(r0);
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
            for (int i = 0; i < 13; ++i) cmap_lru[i] = i;
            which = 1;
            cmidx = 0;
          } else {
            st2 = P_MVMODE;
          }
        } else if (v == 15) {
          st2 = P_CF;
        } else if (v == 13) {
          int mx = cmap_lru[0];
          for (int i = 1; i < 13; ++i) mx = imax(mx, cmap_lru[i]);
          cmap_val = (mx + 1) & 0xFF;
          do_obs = true;
        } else {
          cmap_val = cmap_lru[v];
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
    if (st2 == C_DMN && st != C_DMN) aprior = dcm[imin(imax(nb, 2) - 2, 3)];

    // copy setup: validate the distance, update the LRU, start the run
    if (do_setup) {
      err = err || setup_d <= 0 || setup_d > wpos;
      const int l0 = dlru[0], l1 = dlru[1], l2 = dlru[2], l3 = dlru[3];
      if (setup_d == l1) {
        dlru[0] = setup_d; dlru[1] = l0; dlru[2] = l2; dlru[3] = l3;
      } else if (setup_d == l2) {
        dlru[0] = setup_d; dlru[1] = l0; dlru[2] = l1; dlru[3] = l3;
      } else if (setup_d != l0) {
        dlru[0] = setup_d; dlru[1] = l0; dlru[2] = l1; dlru[3] = l2;
      }
      dist = setup_d;
      st2 = nb > 0 ? COPY_RUN : BEGIN;
    }

    // a context-map value: move to the front of the LRU, store in the map
    if (do_obs) {
      int pos = -1;
      for (int i = 0; i < 13; ++i) {
        if (pos < 0 && cmap_lru[i] == cmap_val) pos = i;
      }
      const int end = pos < 0 ? 12 : pos;
      for (int i = end; i > 0; --i) cmap_lru[i] = cmap_lru[i - 1];
      cmap_lru[0] = cmap_val;
      if (which_old == 0) {
        err = err || cmidx_old >= 64 || cmap_val >= nctx;
        if (cmidx_old < 64) lcm[cmidx_old] = cmap_val;
      } else {
        err = err || cmidx_old >= 4 || cmap_val >= nd;
        if (cmidx_old < 4) dcm[cmidx_old] = cmap_val;
      }
      cmidx = cmidx_old + 1;
    }

    st = err ? ERROR : st2;
  }
  ok_out[b] = (st == DONE && wpos == raw_len) ? 1 : 0;
  wpos_out[b] = wpos;
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
// x 32 B exceeds the shared limit, else null.  Returns cudaGetLastError()
// after the launch.
extern "C" int dtpu_scan_decode(const void* cmd_states, const void* cmd_words,
                                int wc, const void* lit_states,
                                const void* lit_words, int wl,
                                const void* raw_len, const void* params,
                                int num_rows, int max_steps, int win, int b,
                                void* windows, void* ok, void* wpos,
                                void* scratch, void* stream) {
  size_t smem;
  const cudaError_t e = adaptive::model_smem(scan_kernel, num_rows,
                                             scratch != nullptr, &smem);
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(cmd_states), static_cast<const int*>(cmd_words),
      wc, static_cast<const int*>(lit_states),
      static_cast<const int*>(lit_words), wl,
      static_cast<const int*>(raw_len), static_cast<const int*>(params),
      max_steps, win, static_cast<uint8_t*>(windows),
      static_cast<uint8_t*>(ok), static_cast<int*>(wpos),
      static_cast<int16_t*>(scratch));
  return (int)cudaGetLastError();
}
