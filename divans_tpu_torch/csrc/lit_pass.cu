// Deferred-profile literal model pass of the encode, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel divans_tpu/codec/pallas_lit_pass.py:99
// (_make_kernel, launched by _lit_pass_call at :357), the bit-exact twin
// of the XLA pass jax_engine.model_pass_deferred_lit (:387).  Contract,
// per lane (one literal sub-stream against a fresh model):
//   * the model is four row classes of 16-entry CDFs, here in "kernel
//     order": lit_hi[64] (ctx) at 0, cm_first[64] (ctx) at 64,
//     lit_lo[128] at 128 and cm_second[128] at 256, both indexed by
//     idx = (ctx>>3)*16 + hi (cm_second is stored in that order, so it
//     shares the lo class's counts), all starting at CDF_INIT (4, 8..64);
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
// Everything is int32 with the reference's wraps: products and shifts
// are done in uint32 and cast back.
//
// Design.  One thread block per lane, its whole state in shared memory
// for the whole sub-stream: the model (24 KiB), two chunks' count
// histograms (hi [64][16] then lo [128][16], 12 KiB each), the lagged
// mixer adjustments and the weights; 49,216 bytes of dynamic shared
// memory.  One thread per byte of the chunk: the model is frozen within
// a chunk, so the bytes are independent.  A byte needs only three
// entries of each row it fetches (sym-1, sym and 15), so it never
// builds a whole mixed CDF.  Histograms are shared-memory atomicAdds
// (integer, order-free), the adjustments a warp-shuffle reduction.  The
// commit gives each thread whole count rows: the thread that commits
// count row k updates both model rows fed by it and clears it, and the
// renorm loop runs per row (a pass leaves a row under its limit as it
// is, so the per-row loop equals the reference's "while any row is
// over").  Two barriers a chunk: after coding, and after the commit.
//
// What bounds it.  Per nibble ~250 integer operations (six row-entry
// loads, three averages at one entry, five exact divisions of ~25
// instructions each, the adjustment) and per chunk a commit of 384 rows;
// the bytes moved are 2 B in and 8 B out a nibble, so operations bound
// it on paper.  The chain that bounds a block is the chunk loop: two
// barriers and a serial commit per chunk, with at most one block per
// lane, so a batch of B lanes fills only B SMs.  Many lanes per launch,
// a lighter commit, or several lanes a block are later work; the output
// does not depend on how lanes map to blocks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHi = 0, kCm1 = 64, kLo = 128, kCm2 = 256;
constexpr int kRows = 384;          // model rows, kernel order
constexpr int kCntRows = 192;       // count rows: hi (ctx) then lo (idx)
constexpr int kAdjClamp = 1 << 21;
constexpr int kWeightMax = (1 << 30) - 1;
constexpr int kMaxRenorm = 24;
constexpr int kSmemInts = kRows * 16 + 2 * kCntRows * 16 + 2 * 4 + 8;

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

// floor(a / b) for b >= 1 (torch's integer `//`).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b) != 0 && a < 0) --q;
  return q;
}

// (start, freq) of `sym` from the three CDF entries it needs: c_prev =
// cdf[sym-1] (unused for sym 0), c_sym = cdf[sym], c_max = cdf[15].
__device__ __forceinline__ void start_freq(int c_prev, int c_sym, int c_max,
                                           int sym, int& start, int& freq) {
  const int m = max(c_max, 1);
  const int r_sym = floor_div(shl32(c_sym, 15), m);
  const int r_prev = sym > 0 ? floor_div(shl32(c_prev, 15), m) : 0;
  start = r_prev + 1;
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

// One nibble: rows nib/cm (shared memory, or nullptr for CDF_INIT),
// symbol sym, mix flag and masked norm weight -> start, freq and the two
// mixer adjustments (0 where the byte does not mix).
__device__ __forceinline__ void code_nibble(const int* nib, const int* cm,
                                            int sym, bool mix, int rate,
                                            int& start, int& freq,
                                            int& adj_cm, int& adj_nib) {
  const int ip = sym > 0 ? sym - 1 : 0;
  int n_prev, n_sym, n_max, c_prev, c_sym, c_max;
  if (nib != nullptr) {
    n_prev = nib[ip]; n_sym = nib[sym]; n_max = nib[15];
    c_prev = cm[ip];  c_sym = cm[sym];  c_max = cm[15];
  } else {
    n_prev = c_prev = 4 * (ip + 1);
    n_sym = c_sym = 4 * (sym + 1);
    n_max = c_max = 64;
  }
  if (!mix) {
    start_freq(n_prev, n_sym, n_max, sym, start, freq);
    adj_cm = adj_nib = 0;
    return;
  }
  int p_cm, p_nib, unused;
  start_freq(c_prev, c_sym, c_max, sym, unused, p_cm);
  start_freq(n_prev, n_sym, n_max, sym, unused, p_nib);
  const int shift = max(bitlen(mul32(c_max, n_max)) - 15, 0);
  const int m_prev = average_at(c_prev, n_prev, shift, c_max, n_max, rate);
  const int m_sym = average_at(c_sym, n_sym, shift, c_max, n_max, rate);
  const int m_max = average_at(c_max, n_max, shift, c_max, n_max, rate);
  start_freq(m_prev, m_sym, m_max, sym, start, freq);
  const int error = (1 << 15) - freq;
  const int sh = max(bitlen(mul32(freq, error)) - 15, 0);
  adj_cm = min(max(mul32(error, p_cm - freq) >> sh, -kAdjClamp), kAdjClamp);
  adj_nib = min(max(mul32(error, p_nib - freq) >> sh, -kAdjClamp),
                kAdjClamp);
}

// Commit one model row: += inc * cumsum(cnt), then renorm while over.
__device__ __forceinline__ void commit_row(int* row, const int* cnt, int inc,
                                           int lim) {
  int v[16];
  int cum = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    cum += cnt[i];
    v[i] = row[i] + mul32(inc, cum);
  }
  // lim_eff = limsum // tot = lim where the row's total is > 0
  const int lim_eff = (inc != 0 && cum > 0) ? lim : 0x8000;
  for (int p = 0; p < kMaxRenorm && v[15] >= lim_eff; ++p) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int cb = v[i] + i + 1;
      v[i] = cb - (cb >> 2);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) row[i] = v[i];
}

// The mixer weight rules of one "which": clip, 24-bit over-rule,
// norm_weight with its i16 wraps.  w = (w0, w1, nw).
__device__ __forceinline__ void commit_weights(int* w, const int* adj) {
  int w0 = min(max(w[0] + adj[0], 1), kWeightMax);
  int w1 = min(max(w[1] + adj[1], 1), kWeightMax);
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

__global__ void lit_pass_kernel(const uint16_t* __restrict__ rows, int half,
                                const int32_t* __restrict__ spd_all,
                                const int32_t* __restrict__ n_nib_all,
                                int32_t* __restrict__ starts,
                                int32_t* __restrict__ freqs, int chunk) {
  extern __shared__ int smem[];
  int* model = smem;                                 // [384][16]
  int* cnt = model + kRows * 16;                     // [2][192][16]
  int* wadj = cnt + 2 * kCntRows * 16;               // [2][which][cm, nib]
  int* weights = wadj + 2 * 4;                       // [which][w0, w1, nw]

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = chunk >> 1;                          // bytes a chunk
  const int n = 2 * half;
  const int n_nib = n_nib_all[lane];
  const int n_bytes = n_nib >> 1;
  const int n_chunks = (n_nib + chunk - 1) / chunk;
  const int32_t* spd = spd_all + lane * 6;
  const int inc0 = spd[0], lim0 = spd[1], inc2 = spd[2], lim2 = spd[3];
  const int inc3 = spd[4], lim3 = spd[5];
  const uint16_t* row_in = rows + (size_t)lane * half;
  int32_t* st_out = starts + (size_t)lane * n;
  int32_t* fr_out = freqs + (size_t)lane * n;

  for (int i = tid; i < kRows * 16; i += blockDim.x) {
    model[i] = 4 * ((i & 15) + 1);   // CDF_INIT
  }
  for (int i = tid; i < 2 * kCntRows * 16 + 2 * 4; i += blockDim.x) cnt[i] = 0;
  if (tid < 2) {
    weights[3 * tid] = 1;
    weights[3 * tid + 1] = 1;
    weights[3 * tid + 2] = 1 << 14;
  }
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    int* cnt_new = cnt + (c & 1) * kCntRows * 16;
    int* wadj_new = wadj + (c & 1) * 4;
    // ---- code byte t of the chunk against the frozen snapshot
    const int t = c * s + tid;
    const uint32_t p = t < n_bytes ? (uint32_t)row_in[t] : 0u;
    const int ctx = p & 63, hi = (p >> 6) & 15, lo = (p >> 10) & 15;
    const bool act = (p >> 14) & 1;
    const bool mix = act && ((p >> 15) & 1);
    const int idx = ((ctx >> 3) << 4) + hi;
    int st_h, fr_h, ach, anh, st_l, fr_l, acl, anl;
    code_nibble(act ? model + (kHi + ctx) * 16 : nullptr,
                model + (kCm1 + ctx) * 16, hi, mix, weights[5] & 0xFFFF,
                st_h, fr_h, ach, anh);
    code_nibble(act ? model + (kLo + idx) * 16 : nullptr,
                model + (kCm2 + idx) * 16, lo, mix, weights[2] & 0xFFFF,
                st_l, fr_l, acl, anl);
    if (2 * t < n_nib) {
      st_out[2 * t] = st_h;
      st_out[2 * t + 1] = st_l;
      fr_out[2 * t] = fr_h;
      fr_out[2 * t + 1] = fr_l;
    } else if (2 * t < n) {
      st_out[2 * t] = st_out[2 * t + 1] = 0;
      fr_out[2 * t] = fr_out[2 * t + 1] = 0;
    }
    if (act) {
      atomicAdd(cnt_new + ctx * 16 + hi, 1);
      atomicAdd(cnt_new + (64 + idx) * 16 + lo, 1);
    }
    // [which][model]: lo nibble is which 0, hi nibble which 1
    if ((blockDim.x & 31) == 0) {
      acl = warp_sum(acl); anl = warp_sum(anl);
      ach = warp_sum(ach); anh = warp_sum(anh);
      if ((tid & 31) == 0) {
        atomicAdd(wadj_new + 0, acl); atomicAdd(wadj_new + 1, anl);
        atomicAdd(wadj_new + 2, ach); atomicAdd(wadj_new + 3, anh);
      }
    } else if (mix) {
      atomicAdd(wadj_new + 0, acl); atomicAdd(wadj_new + 1, anl);
      atomicAdd(wadj_new + 2, ach); atomicAdd(wadj_new + 3, anh);
    }
    __syncthreads();

    // ---- commit chunk c-1's pend (the other buffer), then clear it
    int* cnt_old = cnt + ((c + 1) & 1) * kCntRows * 16;
    int* wadj_old = wadj + ((c + 1) & 1) * 4;
    for (int k = tid; k < kCntRows; k += blockDim.x) {
      int* cr = cnt_old + k * 16;
      if (k < 64) {
        commit_row(model + (kHi + k) * 16, cr, inc0, lim0);
        commit_row(model + (kCm1 + k) * 16, cr, inc3, lim3);
      } else {
        commit_row(model + (kLo + k - 64) * 16, cr, inc0, lim0);
        commit_row(model + (kCm2 + k - 64) * 16, cr, inc2, lim2);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) cr[i] = 0;
    }
    if (tid == 0) {
      commit_weights(weights, wadj_old);
      commit_weights(weights + 3, wadj_old + 2);
      for (int i = 0; i < 4; ++i) wadj_old[i] = 0;
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

// rows uint16[B, half] packed literal bytes, spd int32[B, 6], n_nib
// int32[B] -> starts, freqs int32[B, 2*half].  One block of chunk/2
// threads per lane.  Launches on `stream` and returns cudaGetLastError()
// (or the error of the shared-memory attribute).
extern "C" int dtpu_lit_pass(const void* rows, int half, const void* spd,
                             const void* n_nib, void* starts, void* freqs,
                             int B, int chunk, void* stream) {
  const int smem = kSmemInts * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      lit_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lit_pass_kernel<<<B, chunk / 2, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)rows, half, (const int32_t*)spd,
      (const int32_t*)n_nib, (int32_t*)starts, (int32_t*)freqs, chunk);
  return (int)cudaGetLastError();
}
