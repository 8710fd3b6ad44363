// Deferred-profile literal decode of a whole lane group, one persistent
// launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel divans_tpu/codec/pallas_decode.py:182
// (_make_lit_kernel, launched by _chunk_call at :295) together with the
// lax.scan around it, _decode_lit_scan_q (:377): the chunk loop, the
// stream switch, the premix and the lagged commit that the reference ran
// as XLA between its kernel calls run here inside one kernel.  Contract,
// per lane (a queue of literal streams, each against a fresh model), for
// each of n_steps chunks of s bytes:
//   1. switch: a lane whose stream is exhausted (n_rem <= 0) and whose
//      queue has more loads the next one (state0, 2*woff, n_lit, lcmap,
//      speeds) and resets model, mixer weights, pend, p1 and p2;
//   2. premix: plane q of the frozen model is cdf16.average(cm, nib,
//      nw & 0xFFFF) of two rows of the committed model (perm), 64 hi
//      planes (ctx; nw of "which" 1) then 128 lo planes ((ctx>>3)*16 +
//      hi; which 0), with the i16 wrap;
//   3. decode up to s bytes, per byte:
//        sel = lut0[p1] | lut1[p2];  ctx = lcmap[sel & 63] & 63
//        hi  = nibble(plane ctx);    lo = nibble(plane 64 + (ctx>>3)*16 + hi)
//      and per nibble (rans32, divans_tpu/ans/coder_np.py):
//        if state < 2^15: state = state << 16 | next u16 word
//        slot = state & 0x7FFF; sym = #{i < 15 : cdf[i] <= (slot*max) >> 15}
//        start/freq from floor(cdf << 15 / max); state = freq*(state>>15)+slot-start
//   4. the chunk's count histograms, hi [64][16] by (ctx, hi) and lo
//      [128][16] by ((ctx>>3)*16 + hi, lo);
//   5. the mixer adjustments of every decoded nibble under the frozen
//      tables (codec/deferred.py rules), summed per "which";
//   6. the histograms and sums become the chunk's pend, and the previous
//      chunk's pend commits (lit_model.apply_pend: add = inc * cumsum,
//      lim_eff = limsum // cnt or 0x8000, n_pass masked renorm passes,
//      the weight clamp, the 24-bit over-rule and norm_weight).
// Everything is int32 with the reference's wraps (products, sums and
// shifts done in uint32 and cast back) and floor division.
//
// Resuming (the reference's carry_in, pallas_decode.py:695-705).  Given
// a carry (the final carry of an earlier launch, or every lane idle:
// fidx -1, n_rem 0), a lane continues where it stopped instead of
// preloading stream 0: its scalars, committed model and weights come
// from the carry, its lcmap and speeds from row fidx of the tables (none
// for fidx < 0; the tables may have grown since, rows only appended),
// and the first chunk's commit takes the carried pend (add, limsum and
// cnt read row by row from device memory, wadj from the carry) unless
// the lane switches streams at that chunk.  The shared memory does not
// grow.
//
// Design.  One block of 256 threads per lane; the lane's whole state
// lives in shared memory for the whole launch: the committed model
// (385 x 16 int32), two chunks' count histograms (the pend is kept as
// counts and expanded with the lane's speeds when it commits), the
// premixed planes (int16) beside their rescaled grids (floor(cdf << 15
// / max), int32), the tables, the chunk's window of renorm words and its
// decoded bytes; about 72 KB of dynamic shared memory.  Per chunk the
// block's threads premix a plane each and divide its grid, one thread
// decodes the bytes (the serial chain), then every thread takes a nibble
// for the histograms and the adjustments (only the decoded (plane, sym)
// pairs, at most 2*s, not 576 x 16 tables), and a row each of the
// commit; five barriers a chunk.  The grids take the divisions off the
// chain: a nibble costs two shared-memory plane loads, the symbol search
// and two grid loads.  Every division is an exact integer floor division.
//
// What bounds it.  The serial nibble chain, ~128 bytes x 2 nibbles a
// chunk (word, plane, symbol search, grid, state; then the context
// lookups of the next byte), from shared memory; per chunk the premix
// (192 x 16 entries and their divisions) and the commit (385 x 16) are
// spread over the block.  The bytes moved (the words, the tables and the
// decoded bytes) are tiny.  Lanes are independent, so a group of L lanes
// fills L SMs; more lanes per group is the next lever (the bytes do not
// depend on the lane count).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 385;     // rebased literal rows (row 0 unused)
constexpr int kPlanes = 192;   // premixed planes: 64 hi, then 128 lo
constexpr int kHistRows = 192; // count rows: hi (ctx), then lo ((ctx>>3)*16+hi)
constexpr int kThreads = 256;
constexpr int kAdjClamp = 1 << 21;
constexpr int kWeightMax = (1 << 30) - 1;
// rebased row offsets of the four classes (lit_model.OFFSETS)
constexpr int kOffHi = 1, kOffLo = 65, kOffCm1 = 193, kOffCm2 = 257;
// per-lane scalars in shared memory
enum { kState, kCursor, kP1, kP2, kNRem, kFidx, kPulls, kNAct, kSwitch,
       kScalars };

__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int shl32(int a, int s) {
  return (int)((uint32_t)a << s);
}

__device__ __forceinline__ int bitlen(int x) {   // 0 for x <= 0
  return x > 0 ? 32 - __clz(x) : 0;
}

__device__ __forceinline__ int wrap16(int x) {
  const int v = x & 0xFFFF;
  return v >= 0x8000 ? v - 0x10000 : v;
}

// floor(a / b) for b >= 1 (torch's integer `//`).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b) != 0 && a < 0) --q;
  return q;
}

// rescaled entry: floor(c << 15 / max(c_max, 1))
__device__ __forceinline__ int rescale(int c, int c_max) {
  return floor_div(shl32(c, 15), max(c_max, 1));
}

// freq of `sym` under a 16-entry CDF row
__device__ __forceinline__ int row_freq(const int* row, int sym) {
  const int m = row[15];
  const int r_prev = sym > 0 ? rescale(row[sym - 1], m) : 0;
  return rescale(row[sym], m) - r_prev - 1;
}

// the cm and nib rows of premixed plane q
__device__ __forceinline__ void plane_rows(const int* perm, int q, int& cm,
                                           int& nib) {
  if (q < 64) {
    cm = perm[64 + q];
    nib = perm[q];
  } else {
    cm = perm[256 + q - 64];
    nib = perm[128 + q - 64];
  }
}

// count row and speed pair of rebased row r: the pend of lit_hi and
// cm_first is the hi counts at ctx, of lit_lo the lo counts, of
// cm_second (stored hi*8 + c3) the lo counts at c3*16 + hi.  Returns
// -1 for row 0.
__device__ __forceinline__ int row_counts(int r, const int* spd, int& inc,
                                          int& lim) {
  if (r >= kOffCm2) {
    const int i = r - kOffCm2;
    inc = spd[2];
    lim = spd[3];
    return 64 + (i % 8) * 16 + i / 8;
  }
  if (r >= kOffCm1) {
    inc = spd[4];
    lim = spd[5];
    return r - kOffCm1;
  }
  inc = spd[0];
  lim = spd[1];
  if (r >= kOffLo) return 64 + r - kOffLo;
  return r >= kOffHi ? r - kOffHi : -1;
}

// one row of a chunk's pend from its counts: add[16], limsum, cnt
__device__ __forceinline__ void pend_row(const int* hist, int r,
                                         const int* spd, int* add,
                                         int& limsum, int& cnt) {
  int inc, lim;
  const int k = row_counts(r, spd, inc, lim);
  int cum = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    cum = add32(cum, k >= 0 ? hist[k * 16 + i] : 0);
    add[i] = mul32(inc, cum);
  }
  cnt = inc != 0 ? cum : 0;
  limsum = mul32(lim, cnt);
}

// one row of a carried pend, from device memory
__device__ __forceinline__ void carry_row(const int32_t* add_in,
                                          const int32_t* limsum_in,
                                          const int32_t* cnt_in, size_t o,
                                          int* add, int& limsum, int& cnt) {
#pragma unroll
  for (int i = 0; i < 16; ++i) add[i] = add_in[o * 16 + i];
  limsum = limsum_in[o];
  cnt = cnt_in[o];
}

// the mixer weight rules of one "which": clip, 24-bit over-rule,
// norm_weight with its i16 wraps.  w = (w0, w1, nw), adj = (cm, nib).
__device__ __forceinline__ void commit_weights(int* w, const int* adj) {
  int w0 = min(max(add32(w[0], adj[0]), 1), kWeightMax);
  int w1 = min(max(add32(w[1], adj[1]), 1), kWeightMax);
  if (((w0 | w1) & 0x7F000000) != 0) {
    const int sh = max(max(bitlen(w0), bitlen(w1)) - 24, 0);
    w0 >>= sh;
    w1 >>= sh;
  }
  const int total = w0 + w1;
  const int shn = max(bitlen(total) - 8, 0);
  const int total8 = total >> shn;
  const int inv = 1 + floor_div(1 << 24, total8);
  const int num = shl32(w0 >> shn, 8);
  const int hi = mul32(inv >> 12, num);
  const int lo = mul32(inv & 0xFFF, num);
  const int q16 = wrap16((hi + (lo >> 12)) >> 12);
  w[0] = w0;
  w[1] = w1;
  w[2] = wrap16(shl32(q16, 7));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Decode one nibble against premixed plane q; int32 wrap semantics.
// `next` holds the renorm word at halfword h of the chunk's window,
// loaded one renorm ahead, so a renorm does not wait on shared memory.
__device__ __forceinline__ int decode_nibble(const int16_t* kmodel,
                                             const int* grid, int q,
                                             const uint16_t* w16, int& h,
                                             uint32_t& next, int32_t& state) {
  if (state < 32768) {
    state = (int32_t)(((uint32_t)state << 16) | next);
    next = w16[++h];
  }
  const int4* p4 = reinterpret_cast<const int4*>(kmodel + q * 16);
  const int4 a = p4[0];
  const int4 b = p4[1];
  const int32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int cdf[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cdf[2 * i] = (int16_t)(v[i] & 0xFFFF);
    cdf[2 * i + 1] = (int16_t)((uint32_t)v[i] >> 16);
  }
  const int slot = state & 0x7FFF;
  const int resc = (slot * cdf[15]) >> 15;
  int le[15];
#pragma unroll
  for (int i = 0; i < 15; ++i) le[i] = cdf[i] <= resc;
  // the count as a tree of adds (depth 4, not a chain of 15)
  const int sym = (((le[0] + le[1]) + (le[2] + le[3])) +
                   ((le[4] + le[5]) + (le[6] + le[7]))) +
                  (((le[8] + le[9]) + (le[10] + le[11])) +
                   ((le[12] + le[13]) + le[14]));
  const int* g = grid + q * 16;
  const int start = (sym > 0 ? g[sym - 1] : 0) + 1;
  const int freq = g[sym] - start;
  state = (int32_t)((uint32_t)freq * (uint32_t)(state >> 15) +
                    (uint32_t)slot - (uint32_t)start);
  return sym;
}

__global__ void __launch_bounds__(kThreads) lit_decode_group_kernel(
    const int32_t* __restrict__ words, int W,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ state0,
    const int32_t* __restrict__ n_lit, const int32_t* __restrict__ woff,
    const int32_t* __restrict__ lcmap_all, const int32_t* __restrict__ spd_all,
    const int32_t* __restrict__ luts_in, const int32_t* __restrict__ perm_in,
    int L, int n_steps, int s, int n_pass, uint8_t* __restrict__ out,
    int32_t* __restrict__ sc_out, int32_t* __restrict__ committed_out,
    int32_t* __restrict__ weights_out, int32_t* __restrict__ add_out,
    int32_t* __restrict__ limsum_out, int32_t* __restrict__ cnt_out,
    int32_t* __restrict__ wadj_out, const int32_t* __restrict__ sc_in,
    const int32_t* __restrict__ committed_in,
    const int32_t* __restrict__ weights_in,
    const int32_t* __restrict__ add_in,
    const int32_t* __restrict__ limsum_in,
    const int32_t* __restrict__ cnt_in, const int32_t* __restrict__ wadj_in) {
  extern __shared__ __align__(16) int smem[];
  int* committed = smem;                          // [385][16]
  int* hist = committed + kRows * 16;             // [2][192][16]
  int* grid = hist + 2 * kHistRows * 16;          // [192][16]
  int16_t* kmodel = (int16_t*)(grid + kPlanes * 16);  // [192][16]
  int* luts = grid + kPlanes * 16 + kPlanes * 8;  // [512]
  int* lcmap = luts + 512;                        // [64]
  int* perm = lcmap + 64;                         // [384]
  int* weights = perm + 384;                      // [which][w0, w1, nw]
  int* wadj = weights + 6;                        // [2][which][cm, nib]
  int* spd = wadj + 8;                            // [6]
  int* sc = spd + 6;                              // kScalars
  int* window = sc + kScalars + 1;                // [s + 2] renorm words
  uint8_t* outb = (uint8_t*)(window + s + 2);     // [s] bytes, then [s] ctx
  uint8_t* outc = outb + s;

  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = counts[l];
  const int32_t* wrow = words + (size_t)l * W;
  const size_t out_row = (size_t)n_steps * s;
  const bool resume = sc_in != nullptr;

  // one lane's model, mixer, pend and tables, fresh for stream fidx
  auto reset = [&](int fidx) {
    for (int i = tid; i < kRows * 16; i += kThreads) {
      committed[i] = 4 * ((i & 15) + 1);          // CDF_INIT
    }
    for (int i = tid; i < 2 * kHistRows * 16; i += kThreads) hist[i] = 0;
    for (int i = tid; i < 64; i += kThreads) {
      lcmap[i] = lcmap_all[((size_t)fidx * L + l) * 64 + i];
    }
    if (tid < 8) wadj[tid] = 0;
    if (tid < 6) spd[tid] = spd_all[((size_t)fidx * L + l) * 6 + tid];
    if (tid < 2) {
      weights[3 * tid] = 1;
      weights[3 * tid + 1] = 1;
      weights[3 * tid + 2] = 1 << 14;
    }
  };

  for (int i = tid; i < 512; i += kThreads) luts[i] = luts_in[i];
  for (int i = tid; i < 384; i += kThreads) perm[i] = perm_in[i];
  if (resume) {
    // the carried lane; its pend's wadj goes where step 0 commits from
    const int fidx = sc_in[kFidx * L + l];
    const size_t f = (size_t)max(fidx, 0) * L + l;
    for (int i = tid; i < kRows * 16; i += kThreads) {
      committed[i] = committed_in[(size_t)l * kRows * 16 + i];
    }
    for (int i = tid; i < 2 * kHistRows * 16; i += kThreads) hist[i] = 0;
    for (int i = tid; i < 64; i += kThreads) {
      lcmap[i] = fidx >= 0 ? lcmap_all[f * 64 + i] : 0;
    }
    if (tid < 6) {
      spd[tid] = fidx >= 0 ? spd_all[f * 6 + tid] : 0;
      weights[tid] = weights_in[l * 6 + tid];
      sc[tid] = sc_in[tid * L + l];              // state .. fidx
    }
    if (tid < 4) {
      wadj[tid] = 0;
      wadj[4 + tid] = wadj_in[l * 4 + tid];
    }
  } else {
    reset(0);
    if (tid == 0) {
      sc[kState] = state0[l];
      sc[kCursor] = woff[l] * 2;
      sc[kP1] = sc[kP2] = 0;
      sc[kNRem] = n_lit[l];
      sc[kFidx] = 0;
    }
  }
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    int* hist_new = hist + (step & 1) * kHistRows * 16;
    int* hist_old = hist + ((step + 1) & 1) * kHistRows * 16;
    int* wadj_new = wadj + (step & 1) * 4;
    int* wadj_old = wadj + ((step + 1) & 1) * 4;
    // ---- 1. stream switch
    if (tid == 0) {
      const int nxt = sc[kFidx] + 1;
      const bool sw = sc[kNRem] <= 0 && nxt < count;
      sc[kSwitch] = sw;
      if (sw) {
        const size_t f = (size_t)nxt * L + l;
        sc[kFidx] = nxt;
        sc[kState] = state0[f];
        sc[kCursor] = woff[f] * 2;
        sc[kP1] = sc[kP2] = 0;
        sc[kNRem] = n_lit[f];
      }
    }
    __syncthreads();
    if (sc[kSwitch]) {
      reset(sc[kFidx]);
      __syncthreads();
    }
    // ---- 2. premix and grids; the chunk's word window; clear the counts
    const int cursor = sc[kCursor];
    const int base = cursor >> 1;
    if (tid < kPlanes) {
      const int q = tid;
      int cm, nib;
      plane_rows(perm, q, cm, nib);
      const int* a = committed + cm * 16;
      const int* b = committed + nib * 16;
      const int rate = weights[q < 64 ? 5 : 2] & 0xFFFF;
      const int inv = (1 << 15) - rate;
      const int amax = a[15], bmax = b[15];
      const int shift = max(bitlen(mul32(amax, bmax)) - 15, 0);
      int mix[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int ra = mul32(a[i], bmax) >> shift;
        const int rb = mul32(b[i], amax) >> shift;
        mix[i] = wrap16(add32(add32(mul32(ra, rate), mul32(rb, inv)), 1) >>
                        15);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        grid[q * 16 + i] = rescale(mix[i], mix[15]);
        kmodel[q * 16 + i] = (int16_t)mix[i];
      }
    }
    for (int j = tid; j < s + 2; j += kThreads) {
      window[j] = wrow[min(base + j, W - 1)];
    }
    for (int i = tid; i < kHistRows * 16; i += kThreads) hist_new[i] = 0;
    if (tid < 4) wadj_new[tid] = 0;
    __syncthreads();

    // ---- 3. the serial decode of the chunk's bytes
    if (tid == 0) {
      int32_t state = sc[kState];
      int p1 = sc[kP1], p2 = sc[kP2];
      // halfword h of the window is word cursor + pulls of the lane's row
      const uint16_t* w16 = reinterpret_cast<const uint16_t*>(window);
      const int h0 = cursor & 1;
      int h = h0;
      uint32_t next = w16[h];
      const int n_act = max(0, min(s, sc[kNRem]));
      for (int t = 0; t < n_act; ++t) {
        const int sel = luts[p1 & 255] | luts[256 + (p2 & 255)];
        const int ctx = lcmap[sel & 63] & 63;
        const int hi = decode_nibble(kmodel, grid, ctx, w16, h, next, state);
        const int lo = decode_nibble(kmodel, grid, 64 + (ctx >> 3) * 16 + hi,
                                     w16, h, next, state);
        const int byte = (hi << 4) | lo;
        outb[t] = (uint8_t)byte;
        outc[t] = (uint8_t)ctx;
        p2 = p1;
        p1 = byte;
      }
      const int pulls = h - h0;
      sc[kState] = state;
      sc[kP1] = p1;
      sc[kP2] = p2;
      sc[kPulls] = pulls;
      sc[kNAct] = n_act;
    }
    __syncthreads();

    // ---- 4-5. bytes out; counts and adjustments of every decoded nibble
    const int n_act = sc[kNAct];
    uint8_t* orow = out + (size_t)l * out_row + (size_t)step * s;
    for (int t = tid; t < s; t += kThreads) orow[t] = t < n_act ? outb[t] : 0;
    int adj[4] = {0, 0, 0, 0};                     // [which][cm, nib]
    for (int k = tid; k < 2 * n_act; k += kThreads) {
      const int byte = outb[k >> 1];
      const int ctx = outc[k >> 1];
      const int hi = byte >> 4;
      const bool is_hi = (k & 1) == 0;
      const int q = is_hi ? ctx : 64 + (ctx >> 3) * 16 + hi;
      const int sym = is_hi ? hi : byte & 15;
      atomicAdd(hist_new + q * 16 + sym, 1);
      const int* g = grid + q * 16;
      const int fw = g[sym] - (sym > 0 ? g[sym - 1] : 0) - 1;
      int cm, nib;
      plane_rows(perm, q, cm, nib);
      const int fc = row_freq(committed + cm * 16, sym);
      const int fn = row_freq(committed + nib * 16, sym);
      const int error = (1 << 15) - fw;
      const int sh = max(bitlen(mul32(fw, error)) - 15, 0);
      const int which = is_hi ? 2 : 0;
      adj[which] += min(max(mul32(error, fc - fw) >> sh, -kAdjClamp),
                        kAdjClamp);
      adj[which + 1] += min(max(mul32(error, fn - fw) >> sh, -kAdjClamp),
                            kAdjClamp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = warp_sum(adj[i]);
      if ((tid & 31) == 0 && v != 0) atomicAdd(wadj_new + i, v);
    }
    __syncthreads();

    // ---- 6. commit the previous chunk's pend (at a resumed lane's first
    // chunk the carried one, unless the lane switched streams)
    const bool carried = resume && step == 0 && !sc[kSwitch];
    for (int r = tid; r < kRows; r += kThreads) {
      int add[16], limsum, cnt;
      if (carried) {
        carry_row(add_in, limsum_in, cnt_in, (size_t)l * kRows + r, add,
                  limsum, cnt);
      } else {
        pend_row(hist_old, r, spd, add, limsum, cnt);
      }
      int v[16];
      int* row = committed + r * 16;
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = add32(row[i], add[i]);
      const int lim_eff = cnt > 0 ? floor_div(limsum, cnt) : 0x8000;
      // masked passes: a row under its limit stays as it is
      for (int p = 0; p < n_pass && v[15] >= lim_eff; ++p) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int cb = v[i] + i + 1;
          v[i] = cb - (cb >> 2);
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) row[i] = v[i];
    }
    if (tid == 0) {
      commit_weights(weights, wadj_old);
      commit_weights(weights + 3, wadj_old + 2);
      sc[kCursor] = cursor + sc[kPulls];
      sc[kNRem] = sc[kNRem] - s;
    }
    __syncthreads();
  }

  // ---- the lane's final carry; the pend is the last chunk's counts
  const int* hist_last = hist + ((n_steps + 1) & 1) * kHistRows * 16;
  const int* wadj_last = wadj + ((n_steps + 1) & 1) * 4;
  for (int r = tid; r < kRows; r += kThreads) {
    int add[16], limsum, cnt;
    if (resume && n_steps == 0) {
      carry_row(add_in, limsum_in, cnt_in, (size_t)l * kRows + r, add,
                limsum, cnt);
    } else {
      pend_row(hist_last, r, spd, add, limsum, cnt);
    }
    const size_t o = ((size_t)l * kRows + r) * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      committed_out[o + i] = committed[r * 16 + i];
      add_out[o + i] = add[i];
    }
    limsum_out[(size_t)l * kRows + r] = limsum;
    cnt_out[(size_t)l * kRows + r] = cnt;
  }
  if (tid < 6) weights_out[l * 6 + tid] = weights[tid];
  if (tid < 4) wadj_out[l * 4 + tid] = wadj_last[tid];
  if (tid < 6) sc_out[tid * L + l] = sc[tid];   // state .. fidx
}

}  // namespace

// Dynamic shared memory of one block for chunks of s bytes.
static int smem_bytes(int s) {
  const int ints = kRows * 16 + 2 * kHistRows * 16 + kPlanes * 16 +
                   kPlanes * 8 + 512 + 64 + 384 + 6 + 8 + 6 + kScalars + 1 +
                   (s + 2) + (2 * s + 3) / 4;
  return ints * (int)sizeof(int);
}

// words int32[L,W]; counts int32[L]; state0, n_lit, woff int32[F,L];
// lcmap int32[F,L,64]; spd int32[F,L,6]; luts int32[512] (lut0 ++ lut1);
// perm int32[384] (kernel plane -> rebased row) -> out uint8[L,
// n_steps*s], sc_out int32[6,L] (state, cursor, p1, p2, n_rem, fidx),
// committed int32[L,385,16], weights int32[L,2,3], and the last chunk's
// pend: add int32[L,385,16], limsum, cnt int32[L,385], wadj int32[L,2,2].
// sc_in .. wadj_in: a carry of the same layout to resume from, or all
// null (each lane preloads stream 0).  One block per lane.  Launches on
// `stream` and returns cudaGetLastError() (or the error of the
// shared-memory attribute).
extern "C" int dtpu_lit_decode_group(
    const void* words, int W, const void* counts, const void* state0,
    const void* n_lit, const void* woff, const void* lcmap, const void* spd,
    const void* luts, const void* perm, int L, int n_steps, int s,
    int n_pass, void* out, void* sc_out, void* committed, void* weights,
    void* add, void* limsum, void* cnt, void* wadj, const void* sc_in,
    const void* committed_in, const void* weights_in, const void* add_in,
    const void* limsum_in, const void* cnt_in, const void* wadj_in,
    void* stream) {
  const int smem = smem_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(
      lit_decode_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  lit_decode_group_kernel<<<L, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)words, W, (const int32_t*)counts,
      (const int32_t*)state0, (const int32_t*)n_lit, (const int32_t*)woff,
      (const int32_t*)lcmap, (const int32_t*)spd, (const int32_t*)luts,
      (const int32_t*)perm, L, n_steps, s, n_pass, (uint8_t*)out,
      (int32_t*)sc_out, (int32_t*)committed, (int32_t*)weights,
      (int32_t*)add, (int32_t*)limsum, (int32_t*)cnt, (int32_t*)wadj,
      (const int32_t*)sc_in, (const int32_t*)committed_in,
      (const int32_t*)weights_in, (const int32_t*)add_in,
      (const int32_t*)limsum_in, (const int32_t*)cnt_in,
      (const int32_t*)wadj_in);
  return (int)cudaGetLastError();
}
