// Deferred-profile literal model pass of the encode, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel divans_tpu/codec/pallas_lit_pass.py:99
// (_make_kernel, launched by _lit_pass_call at :357), the bit-exact twin
// of the XLA pass jax_engine.model_pass_deferred_lit (:387).  Contract,
// per lane (one literal sub-stream against a fresh model):
//   * the model is four row classes of 16-entry CDFs: lit_hi[64] and
//     cm_first[64] indexed by ctx, lit_lo[128] and cm_second[128] both
//     indexed by idx = (ctx>>3)*16 + hi (cm_second is taken in that
//     order, so it shares the lo class's counts), all starting at
//     CDF_INIT (4, 8..64);
//   * every byte of chunk c is coded against the snapshot committed
//     through chunk c-2: fetch the nibble row and the cm row (CDF_INIT
//     for an inactive byte), mix them where `mix` is set
//     (cdf16.average(cm, nib, nw & 0xFFFF), nw the norm weight of
//     "which" = 1 for the hi nibble, 0 for the lo), take (start, freq)
//     of the symbol, and the mixer adjustment of p_cm and p_nib;
//   * at the end of chunk c the counts of chunk c become the pend and
//     chunk c-1's pend commits: add = inc * cumsum(cnt) per row,
//     lim_eff = lim where the row's total > 0 else 0x8000, renorm
//     passes while row[15] >= lim_eff (at most 24), and the mixer
//     weights take their summed adjustments (clip, 24-bit over-rule,
//     norm_weight).  Speeds: lit_hi and lit_lo sp0, cm_first sp3,
//     cm_second sp2; a speed with inc == 0 records nothing.
// A lane's nibble count is clamped to [0, N].  Everything is int32 with
// the reference's wraps: products and shifts are done in uint32 and cast
// back.
//
// Design.  One thread block per lane, the lane's whole state in shared
// memory for the whole sub-stream: two copies of the model (384 rows of
// 16 int32, each padded to 20 ints so that a thread's 16-byte accesses
// to its own row meet no bank conflict: 2 x 30 KiB), two chunks' count
// histograms (192 rows of 20 ints, 2 x 15 KiB), the row masks, two
// copies of the mixer weights, two chunks' adjustments (a slot for each
// coder warp) and a pair of CDF_INIT rows (what an inactive byte
// reads): 92,832 bytes of dynamic shared memory.  Count row k (hi
// nibbles: ctx, k < 64; lo nibbles: 64 + idx) feeds model row 2k
// (lit_hi or lit_lo, speed 0) and 2k+1 (cm_first, speed 3, or
// cm_second, speed 2), so a nibble's two rows lie side by side.  A
// chunk is one phase and one barrier; three kinds of thread never meet
// in it:
//   * coders (threads 416..416+C-1, C = chunk clamped to [32, 256]; at
//     chunk 512 and 1024 each codes 2 or 4 nibbles) code chunk c from
//     one copy of the model and of the weights, the snapshot through
//     c-2.  A nibble (the model is frozen within a chunk, so nibbles
//     are independent, and so are a byte's hi and lo) reads three
//     entries of each of its two rows (sym-1, sym, 15) straight from
//     shared memory, divides in double precision (an exact floor
//     division: one reciprocal for the two numerators of a divisor, a
//     remainder test; a mixing nibble's three divisors with no branch
//     between them, so that their chains overlap), counts with a shared
//     atomicAdd into chunk c's histogram and marks its rows in chunk c's
//     `counted` mask (atomicOr); the adjustments are summed by warp
//     reductions over the lanes of one nibble parity (even lanes code
//     hi nibbles) into the warp's own slot.  Its packed byte was loaded
//     two chunks ahead; its stores are coalesced;
//   * committers (threads 0..383, one model row each) write the snapshot
//     through c-1 into the other copy.  Thread m commits row m only
//     where the rule can change it: a row chunk c-1 did not count
//     commits with lim_eff = 0x8000, so it changes only if its entry 15
//     is at or above 0x8000, known from its own last commit (the `over`
//     mask, set by ballot).  A commit adds inc times the cumulative
//     counts, then renorm passes while entry 15 >= lim_eff (the per-row
//     rule equals the reference's "while any row is over": a pass
//     leaves a row under its limit unchanged), and clears the count row
//     once both of its model rows have read it.  A row committed into
//     the other copy a chunk earlier and not now is copied across, so
//     the copy the next chunk reads is whole: it takes the commit's own
//     path, since it has no counts and, not being over, meets no renorm
//     pass.  Warp w owns rows 32w..32w+31, the bits of word w of the
//     masks: a warp with nothing to do skips the phase;
//   * two weight threads (lanes 0 and 1 of warp 12) add chunk c-1's
//     slots and commit the weights of "which" 0 and 1 into the other
//     copy.
// The TPU kernel's 8-lane tiles, bf16 one-hot matmuls for the fetch and
// the histograms, and its f32-reciprocal division are not carried over.
//
// What bounds it.  Per nibble ~250 instructions (six row-entry loads,
// three averages at one entry, three reciprocals and six floor divisions
// on the FP64 unit, the adjustment, the atomics, the stores), per
// counted or over row a commit of ~100 (16 entries of ~6, plus the
// renorm passes), per other row one test of a mask bit; 2 B in and 8 B
// out a nibble, so operations bound it on paper.  What bounds a block is
// the chunk loop's chain, the coders': their scattered row gathers and
// histogram atomics through shared memory, the reciprocal and division
// chain of the mixed row (which needs the averages first), the warp
// reductions, then the barrier; the commit, a row a thread, finishes
// well before them.  One block per lane, so a batch of B lanes fills B
// SMs; the output does not depend on how lanes map to blocks.
#include <cstdint>
#include <cuda_runtime.h>

#include "floor_div.cuh"

namespace {

constexpr int kRows = 384;          // model rows: 2k nibble, 2k+1 cm
constexpr int kCntRows = 192;       // count rows: hi (ctx) then lo (idx)
// a row of the models and counts takes 20 ints, so that a thread's
// 16-byte accesses to its own row meet no bank conflict
constexpr int kRowInts = 20;
constexpr int kWords = kRows / 32;  // a model-row mask
constexpr int kCoderBase = kRows + 32;    // committers, the weight warp
constexpr int kMaxCoders = 256;
constexpr int kCoderWarps = kMaxCoders / 32;   // at most
constexpr int kMaxIters = 1024 / kMaxCoders;   // nibbles a coder, at most
constexpr int kAdjClamp = 1 << 21;
constexpr int kWeightMax = (1 << 30) - 1;
constexpr int kMaxRenorm = 24;
constexpr int kSmemInts = 2 * kRows * kRowInts + 2 * kCntRows * kRowInts
                          + 4 * kWords   // counted (2 parities), over, moved
                          + 2 * 2 * 4    // weights [copy][which][w0 w1 nw -]
                          + 2 * kCoderWarps * 4   // adjustments, below
                          + 2 * kRowInts;  // the CDF_INIT pair
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
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

// (start, freq) of `sym` from the three CDF entries it needs: c_prev =
// cdf[sym-1] (unused for sym 0), c_sym = cdf[sym], c_max = cdf[15].  Both
// numerators are divided whatever sym is, so that no branch keeps the
// compiler from interleaving a nibble's three calls.
__device__ __forceinline__ void start_freq(int c_prev, int c_sym, int c_max,
                                           int sym, int& start, int& freq) {
  const int m = max(c_max, 1);
  const double rcp = 1.0 / (double)m;
  const int r_sym = floor_div(shl32(c_sym, 15), m, rcp);
  const int r_prev = floor_div(shl32(c_prev, 15), m, rcp);
  start = (sym > 0 ? r_prev : 0) + 1;
  freq = r_sym - start;
}

// cdf16.average(a, b, rate) at one entry: a = cm, b = nib.
__device__ __forceinline__ int average_at(int a_i, int b_i, int shift,
                                          int amax, int bmax, int rate) {
  const int ra = mul32(a_i, bmax) >> shift;
  const int rb = mul32(b_i, amax) >> shift;
  const int inv = (1 << 15) - rate;
  return wrap16((int)((uint32_t)mul32(ra, rate) + (uint32_t)mul32(rb, inv) +
                      1u) >> 15);
}

// One nibble: its row pair (the nibble row, then its cm row kRowInts
// on; the CDF_INIT pair for an inactive byte), symbol sym, mix flag and
// masked norm weight -> start, freq and the two mixer adjustments (0
// where the byte does not mix).  Called by every lane of a warp.  Where
// any lane mixes, every lane takes all three (start, freq) pairs with no
// branch between them and selects; a warp where no lane mixes takes the
// nibble row's alone.
__device__ __forceinline__ void code_nibble(const int* nib, int sym,
                                            bool mix, int rate, int& start,
                                            int& freq, int& adj_cm,
                                            int& adj_nib) {
  const int ip = sym > 0 ? sym - 1 : 0;
  const int* cm = nib + kRowInts;
  const int n_prev = nib[ip], n_sym = nib[sym], n_max = nib[15];
  adj_cm = adj_nib = 0;
  if (!__any_sync(kFull, mix)) {
    start_freq(n_prev, n_sym, n_max, sym, start, freq);
    return;
  }
  const int c_prev = cm[ip], c_sym = cm[sym], c_max = cm[15];
  int s_nib, p_nib, p_cm, s_mix, f_mix, unused;
  start_freq(n_prev, n_sym, n_max, sym, s_nib, p_nib);
  start_freq(c_prev, c_sym, c_max, sym, unused, p_cm);
  const int shift = max(bitlen(mul32(c_max, n_max)) - 15, 0);
  const int m_prev = average_at(c_prev, n_prev, shift, c_max, n_max, rate);
  const int m_sym = average_at(c_sym, n_sym, shift, c_max, n_max, rate);
  const int m_max = average_at(c_max, n_max, shift, c_max, n_max, rate);
  start_freq(m_prev, m_sym, m_max, sym, s_mix, f_mix);
  start = mix ? s_mix : s_nib;
  freq = mix ? f_mix : p_nib;
  if (mix) {
    const int error = (1 << 15) - freq;
    const int sh = max(bitlen(mul32(freq, error)) - 15, 0);
    adj_cm = min(max(mul32(error, p_cm - freq) >> sh, -kAdjClamp),
                 kAdjClamp);
    adj_nib = min(max(mul32(error, p_nib - freq) >> sh, -kAdjClamp),
                  kAdjClamp);
  }
}

// The mixer weight rules of one "which": clip, 24-bit over-rule,
// norm_weight with its i16 wraps.  (w0, w1, nw) from `src` and the
// summed adjustments (cm, nib) `adj` into `dst`.
__device__ __forceinline__ void commit_weights(const int* src, const int* adj,
                                               int* dst) {
  int w0 = min(max(add32(src[0], adj[0]), 1), kWeightMax);
  int w1 = min(max(add32(src[1], adj[1]), 1), kWeightMax);
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
  dst[0] = w0;
  dst[1] = w1;
  dst[2] = wrap16(shl32(q16, 7));
}

__global__ void __launch_bounds__(kCoderBase + kMaxCoders)
lit_pass_kernel(const uint16_t* __restrict__ rows, int half,
                const int32_t* __restrict__ spd_all,
                const int32_t* __restrict__ n_nib_all,
                int32_t* __restrict__ starts, int32_t* __restrict__ freqs,
                int chunk, int coders) {
  extern __shared__ __align__(16) int smem[];
  int* model = smem;                                    // [2][384][20]
  int* cnt = model + 2 * kRows * kRowInts;              // [2][192][20]
  unsigned* counted = (unsigned*)(cnt + 2 * kCntRows * kRowInts);  // [2][12]
  unsigned* over = counted + 2 * kWords;                // [12]
  unsigned* moved = over + kWords;                      // [12]
  int* wts = (int*)(moved + kWords);                    // [2][2][4]
  // [parity][coder warp][lo cm, lo nib, hi cm, hi nib]
  int* wadj = wts + 2 * 2 * 4;                          // [2][8][4]
  int* init_pair = wadj + 2 * kCoderWarps * 4;          // [2][20]

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = chunk >> 1;                             // bytes a chunk
  const int n = 2 * half;
  // a count past the row (or below 0) is clamped: the lane's outputs
  // stay inside its row whatever the caller passes
  const int n_nib = min(max(n_nib_all[lane], 0), n);
  const int n_bytes = n_nib >> 1;
  const int n_chunks = (n_nib + chunk - 1) / chunk;
  const uint16_t* row_in = rows + (size_t)lane * half;
  int32_t* st_out = starts + (size_t)lane * n;
  int32_t* fr_out = freqs + (size_t)lane * n;

  for (int i = tid; i < 2 * kRows * kRowInts; i += blockDim.x) {
    model[i] = 4 * (i % kRowInts + 1);   // CDF_INIT (and 4 padding ints)
  }
  for (int i = tid; i < 2 * kCntRows * kRowInts; i += blockDim.x) cnt[i] = 0;
  if (tid < 4 * kWords) counted[tid] = 0;   // counted, over and moved
  if (tid < 4) {                            // both copies, both "which"
    wts[4 * tid] = 1;
    wts[4 * tid + 1] = 1;
    wts[4 * tid + 2] = 1 << 14;
    wts[4 * tid + 3] = 0;
  }
  if (tid < 2 * kCoderWarps * 4) wadj[tid] = 0;
  if (tid < 2 * kRowInts) init_pair[tid] = 4 * (tid % kRowInts + 1);
  // a committer's speed (inc, lim): sp0 for row 2k, sp3 (k < 64) or sp2
  // for row 2k+1
  int inc = 0, lim = 0x8000;
  if (tid < kRows) {
    const int col = (tid & 1) == 0 ? 0 : (tid < 128 ? 4 : 2);
    inc = spd_all[lane * 6 + col];
    lim = spd_all[lane * 6 + col + 1];
  }
  // a coder's nibbles j0 + i * coders; their bytes of chunks 0 and 1
  const int j0 = tid - kCoderBase;
  uint32_t p_next[kMaxIters], p_after[kMaxIters];
#pragma unroll
  for (int i = 0; i < kMaxIters; ++i) {
    const int b = (j0 + i * coders) >> 1;
    const bool mine = j0 >= 0 && j0 + i * coders < chunk;   // live
    p_next[i] = mine && b < half ? (uint32_t)row_in[b] : 0u;
    p_after[i] = mine && s + b < half ? (uint32_t)row_in[s + b] : 0u;
  }
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int par = c & 1, pp = par ^ 1;
    const int* snap = model + par * kRows * kRowInts;   // through c-2
    int* next = model + pp * kRows * kRowInts;          // through c-1
    if (j0 >= 0) {
      // ---- code chunk c's nibbles against the frozen snapshot
      int* cnt_new = cnt + par * kCntRows * kRowInts;
      unsigned* counted_new = counted + par * kWords;
      const int* w_now = wts + par * 8;
      int acc_cm = 0, acc_nib = 0;
#pragma unroll
      for (int i = 0; i < kMaxIters; ++i) {
        const int j = j0 + i * coders;
        if (i * coders < chunk) {             // warp-uniform
          const bool live = j < chunk;        // false only at chunk 16
          const uint32_t p = p_next[i];
          const int b = c * s + (j >> 1);
          p_next[i] = p_after[i];
          p_after[i] = live && b + 2 * s < half
                           ? (uint32_t)row_in[b + 2 * s] : 0u;
          const bool hi_nib = (j & 1) == 0;
          const int ctx = p & 63, h = (p >> 6) & 15;
          const int sym = hi_nib ? h : (p >> 10) & 15;
          const bool act = live && ((p >> 14) & 1) && b < n_bytes;
          const bool mix = act && ((p >> 15) & 1);
          const int k = hi_nib ? ctx : 64 + ((ctx >> 3) << 4) + h;
          // which 1 (hi) at w_now[4..7], which 0 (lo) at w_now[0..3]
          const int rate = w_now[hi_nib ? 6 : 2] & 0xFFFF;
          int start, freq, adj_cm, adj_nib;
          code_nibble(act ? snap + 2 * k * kRowInts : init_pair, sym, mix,
                      rate, start, freq, adj_cm, adj_nib);
          const int q = c * chunk + j;
          if (live) {
            st_out[q] = q < n_nib ? start : 0;
            fr_out[q] = q < n_nib ? freq : 0;
          }
          if (act) {
            atomicAdd(cnt_new + k * kRowInts + sym, 1);
            atomicOr(counted_new + (k >> 4), 3u << ((2 * k) & 31));
          }
          acc_cm = add32(acc_cm, adj_cm);
          acc_nib = add32(acc_nib, adj_nib);
        }
      }
      // the warp's sums over the lanes of one parity: even lanes code hi
      // nibbles (which 1), odd lanes lo nibbles (which 0)
      const bool odd = (tid & 1) != 0;
      const int hi_cm = __reduce_add_sync(kFull, odd ? 0 : acc_cm);
      const int hi_nib = __reduce_add_sync(kFull, odd ? 0 : acc_nib);
      const int lo_cm = __reduce_add_sync(kFull, odd ? acc_cm : 0);
      const int lo_nib = __reduce_add_sync(kFull, odd ? acc_nib : 0);
      if ((tid & 31) == 0) {
        reinterpret_cast<int4*>(wadj + par * kCoderWarps * 4)[j0 >> 5] =
            make_int4(lo_cm, lo_nib, hi_cm, hi_nib);
      }
    } else if (tid < kRows) {
      // ---- commit row tid where chunk c-1 counted it or its entry 15
      // is at or above 0x8000, into the other copy; carry the rows the
      // last chunk committed and this one does not
      const int w = tid >> 5, l = tid & 31;
      const unsigned todo = counted[pp * kWords + w] | over[w];
      const unsigned carry = moved[w] & ~todo;
      unsigned high_rows = 0;
      if ((todo | carry) != 0) {            // warp-uniform
        const bool mine = ((todo | carry) >> l) & 1u;
        int4* cr = reinterpret_cast<int4*>(
            cnt + pp * kCntRows * kRowInts + (tid >> 1) * kRowInts);
        bool high = false;
        if (mine) {
          const int4* from =
              reinterpret_cast<const int4*>(snap + tid * kRowInts);
          int4* to = reinterpret_cast<int4*>(next + tid * kRowInts);
          int v[16], cum[16];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int4 m = from[q], k = cr[q];
            v[4 * q] = m.x, v[4 * q + 1] = m.y, v[4 * q + 2] = m.z,
            v[4 * q + 3] = m.w;
            cum[4 * q] = k.x, cum[4 * q + 1] = k.y, cum[4 * q + 2] = k.z,
            cum[4 * q + 3] = k.w;
          }
#pragma unroll
          for (int i = 1; i < 16; ++i) cum[i] += cum[i - 1];
#pragma unroll
          for (int i = 0; i < 16; ++i) v[i] = add32(v[i], mul32(inc, cum[i]));
          // lim_eff = limsum // tot = lim where the row's total is > 0
          const int lim_eff = (inc != 0 && cum[15] > 0) ? lim : 0x8000;
          for (int p = 0; p < kMaxRenorm && v[15] >= lim_eff; ++p) {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int cb = add32(v[i], i + 1);
              v[i] = cb - (cb >> 2);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            to[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                              v[4 * q + 3]);
          }
          high = v[15] >= 0x8000;
        }
        high_rows = __ballot_sync(kFull, high);
        __syncwarp();                       // both rows have read the counts
        // a count row with counts has both its rows counted, so the
        // even one clears it
        if (mine && (l & 1) == 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) cr[q] = make_int4(0, 0, 0, 0);
        }
      }
      __syncwarp();                         // the warp has read its words
      if (l == 0) {
        over[w] = (over[w] & ~todo) | high_rows;
        counted[pp * kWords + w] = 0;       // chunk c+1's mask
        moved[w] = todo;
      }
    } else if (tid < kRows + 2) {
      // ---- the weights of "which" tid - kRows, through chunk c-1
      const int which = tid - kRows;
      int adj[2] = {0, 0};
      for (int g = 0; g < coders / 32; ++g) {
        const int* a = wadj + (pp * kCoderWarps + g) * 4 + which * 2;
        adj[0] = add32(adj[0], a[0]);
        adj[1] = add32(adj[1], a[1]);
      }
      commit_weights(wts + par * 8 + which * 4, adj,
                     wts + pp * 8 + which * 4);
    }
    __syncthreads();
  }
  // chunks past the lane's last one
  for (int i = n_chunks * chunk + tid; i < n; i += blockDim.x) {
    st_out[i] = 0;
    fr_out[i] = 0;
  }
}

}  // namespace

// Threads of a block at `chunk`: committers, the weight warp and the
// coders, chunk clamped to [32, 256].
extern "C" int dtpu_lit_pass_threads(int chunk) {
  return kCoderBase + (chunk < 32 ? 32 : (chunk > kMaxCoders ? kMaxCoders
                                                              : chunk));
}

// rows uint16[B, half] packed literal bytes, spd int32[B, 6], n_nib
// int32[B] -> starts, freqs int32[B, 2*half].  One block of
// dtpu_lit_pass_threads(chunk) threads per lane; chunk is a power of two
// in [16, 1024] dividing 2*half.  Launches on `stream` and returns
// cudaGetLastError() (or the error of the shared-memory attribute).
extern "C" int dtpu_lit_pass(const void* rows, int half, const void* spd,
                             const void* n_nib, void* starts, void* freqs,
                             int B, int chunk, void* stream) {
  const int smem = kSmemInts * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      lit_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = dtpu_lit_pass_threads(chunk);
  lit_pass_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)rows, half, (const int32_t*)spd,
      (const int32_t*)n_nib, (int32_t*)starts, (int32_t*)freqs, chunk,
      threads - kCoderBase);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a launch (bytes).
extern "C" int dtpu_lit_pass_smem() { return kSmemInts * (int)sizeof(int); }
