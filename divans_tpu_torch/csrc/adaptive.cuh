// The adaptive profile's scalar integer arithmetic, shared by the
// per-nibble model pass (model_pass.cu) and the decode scan
// (scan_decode.cu): cdf16's average and (start, freq), and the two-model
// mixer's update, each exactly as the reference's XLA programs compute
// it on int32 (divans_tpu/probability/cdf16.py, weights.py):
//   * a row is 16 int16 entries, 32 bytes;
//   * every sum and product that can leave int32 is taken in uint32 and
//     cast back (XLA's int32 wraps), every i16 cast wraps;
//   * `//` is floor division, and a divisor of 0 or below (a row whose
//     max wrapped) divides as XLA does: by 0 it gives -1 for 0 and -2
//     otherwise;
//   * an arithmetic shift by an amount outside [0, 31] fills the word
//     with the sign, as XLA's and numpy's do.
// Every divisor is a row's entry 15, an int16, so each division goes
// through a 32,769-entry table of 32-bit reciprocals (Recip, xdiv).
// The warp-wide row operations (a lane an entry) are adaptive_warp.cuh's.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace adaptive {

constexpr int kLog2Scale = 15;
constexpr int kWeightMax = (1 << 30) - 1;
constexpr int kNormWeightInit = 1 << 14;

__device__ __forceinline__ int wrap16(uint32_t x) {
  return (int)(int16_t)(uint16_t)x;
}

__device__ __forceinline__ int bit_length(int x) {
  return x > 0 ? 32 - __clz(x) : 0;
}

__device__ __forceinline__ int sra(int x, int s) {
  return (unsigned)s > 31u ? (x < 0 ? -1 : 0) : x >> s;
}

__device__ __forceinline__ int shl(int x, int s) {
  return (int)((uint32_t)x << s);
}

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// Division by a row's entry 15 (an int16) through a table of 32-bit
// reciprocals: for every d in [1, 2^15], m = ceil(2^(31 + L) / d) with
// L = floor(log2 d), so 2^30 < m <= 2^31.  The weight chains keep the
// table's hot range [2^14, 2^15] in shared memory: every mixed row's max
// lies there (the average scales its sides to 15 bits).
constexpr int kHotLo = 1 << 14;
constexpr int kHotLen = (1 << 14) + 1;
constexpr size_t kHotBytes = kHotLen * sizeof(uint32_t);

// A divisor b as its table entry, read once for every quotient by b:
// from `hot` (the hot range in shared memory, or null) when it has it,
// else from the global table.
struct Recip {
  uint32_t m;
  int shift;
  bool neg, zero;
};

__device__ __forceinline__ Recip recip_of(int b, const uint32_t* table,
                                          const uint32_t* hot = nullptr) {
  Recip r;
  const int d = b < 0 ? -b : b;
  r.shift = 62 - __clz(d | 1);   // 31 + L
  r.m = (hot != nullptr && d >= kHotLo) ? hot[d - kHotLo]
                                        : __ldg(table + d);
  r.neg = b < 0;
  r.zero = b == 0;
  return r;
}

// The table's hot range copied into shared memory by the block's
// threads; the caller syncs.
__device__ __forceinline__ void load_hot(uint32_t* hot,
                                         const uint32_t* table) {
  for (int i = threadIdx.x; i < kHotLen; i += blockDim.x) {
    hot[i] = table[kHotLo + i];
  }
}

// floor(a / b) for |a| <= 2^30, as XLA's jnp `//` (by 0: -1 for 0, -2
// otherwise; by b < 0: floor(-a / -b)), without a branch.  With x = a
// (-a for b < 0) and s = x, or ~x = -x - 1 below 0 (s <= 2^30):
// floor(s / d) = (s m) >> (31 + L) exactly, as s (m d - 2^(31 + L)) <
// s d < 2^(31 + L) keeps the fraction below 1; and floor(x / d) =
// ~floor(~x / d) below 0.
__device__ __forceinline__ int xdiv(int a, const Recip& r) {
  const int x = r.neg ? -a : a;
  const uint32_t s = x >= 0 ? (uint32_t)x : ~(uint32_t)x;
  const uint32_t q0 = (uint32_t)(((uint64_t)s * r.m) >> r.shift);
  const int q = x >= 0 ? (int)q0 : ~(int)q0;
  return r.zero ? (a == 0 ? -1 : -2) : q;
}

// floor(c << 15 / maxv): one entry's quotient in sym_to_start_freq
__device__ __forceinline__ int scaled(int c, const Recip& maxv) {
  return xdiv(shl(c, kLog2Scale), maxv);
}

// (start, freq) of symbol sym from the quotients of entries sym - 1 and
// sym (r_prev is ignored for sym 0): start = r_prev + 1 (1 for sym 0),
// freq = r_sym - r_prev - 1
__device__ __forceinline__ void start_freq_of(int r_prev, int r_sym, int sym,
                                              int* start, int* freq) {
  const int rp = sym > 0 ? r_prev : 0;
  *start = rp + 1;
  *freq = (int)((uint32_t)r_sym - (uint32_t)rp - 1u);
}

// The largest model a block keeps in shared memory (R x 32 B), leaving
// each adaptive kernel at least 35 KiB of a block's 232,448 B for its
// own tiles, ring and tables (cm 76,128 B and stride 146,304 B fit; a
// larger model, mix at 22,859 rows, takes a global scratch slab of R x
// 32 B per frame).
constexpr int kMaxShared = 196608;

// Every row of a frame's model set to CDF_INIT (4, 8, ..., 64) by the
// block's threads, two 16-byte words a row; the caller syncs the block.
// The model is the dynamic shared memory, or the frame's share of a
// global scratch slab (a kernel instantiated for each, so that the
// compiler knows which memory a model access goes to).
__device__ __forceinline__ void fill_model(int16_t* model, int num_rows) {
  // CDF_INIT as packed int16 pairs
  const int4 lo = make_int4(4 | 8 << 16, 12 | 16 << 16, 20 | 24 << 16,
                            28 | 32 << 16);
  const int4 hi = make_int4(36 | 40 << 16, 44 | 48 << 16, 52 | 56 << 16,
                            60 | 64 << 16);
  int4* m4 = reinterpret_cast<int4*>(model);
  for (int i = threadIdx.x; i < 2 * num_rows; i += blockDim.x) {
    m4[i] = (i & 1) ? hi : lo;
  }
}

// A launch's dynamic shared memory: the model's R x 32 B (none with a
// scratch slab) plus `extra` bytes of the kernel's own; lifts the
// kernel's limit where it passes 48 KiB.
template <typename Kernel>
inline cudaError_t model_smem(Kernel kernel, int num_rows, bool slab,
                              size_t extra, size_t* smem) {
  if (!slab && (size_t)num_rows * 32 > (size_t)kMaxShared) {
    return cudaErrorInvalidValue;
  }
  *smem = (slab ? 0 : (size_t)num_rows * 32) + extra;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// cdf16.average of one entry: mix * a + (1 - mix) * b in 15-bit fixed
// point, each side first scaled by the other's max
struct Mix {
  int amax, bmax, shift, rate, inv;
};

__device__ __forceinline__ int mix_shift(int amax, int bmax) {
  const int b = bit_length(amax * bmax) - 15;
  return b > 0 ? b : 0;
}

__device__ __forceinline__ Mix mix_of(int amax, int bmax, int rate) {
  Mix m;
  m.amax = amax;
  m.bmax = bmax;
  m.shift = mix_shift(amax, bmax);
  m.rate = rate;
  m.inv = (1 << 15) - rate;
  return m;
}

// the average from its two pre-scaled sides, ra = (a * bmax) >> shift
// and rb = (b * amax) >> shift
__device__ __forceinline__ int average_scaled(int ra, int rb, int rate) {
  const int s = (int)((uint32_t)ra * (uint32_t)rate
                      + (uint32_t)rb * (uint32_t)((1 << 15) - rate) + 1u);
  return wrap16((uint32_t)(s >> 15));
}

// the same as a line in the rate: ra rate + rb (2^15 - rate) + 1 =
// (ra - rb) rate + (rb << 15) + 1 in uint32, so a chain that knows the
// sides before the rate takes one multiply-add
__device__ __forceinline__ int mix_slope(int ra, int rb) {
  return (int)((uint32_t)ra - (uint32_t)rb);
}

__device__ __forceinline__ int mix_base(int rb) {
  return (int)(((uint32_t)rb << 15) + 1u);
}

__device__ __forceinline__ int average_linear(int slope, int base, int rate) {
  const int s = (int)((uint32_t)slope * (uint32_t)rate + (uint32_t)base);
  return wrap16((uint32_t)(s >> 15));
}

__device__ __forceinline__ int average(const Mix& m, int a, int b) {
  return average_scaled((a * m.bmax) >> m.shift, (b * m.amax) >> m.shift,
                        m.rate);
}

// norm_weight's floor_div(1 << 24, total8) for every 8-bit total8 (its
// divisor; 0 never occurs, as the weights are at least 1 each), written
// into a block's shared table by its threads; the caller syncs
__device__ __forceinline__ void init_inv_table(int* table) {
  for (int d = threadIdx.x; d < 256; d += blockDim.x) {
    table[d] = d == 0 ? 0 : (1 << 24) / d;
  }
}

// weights.norm_weight: 15-bit w0 / (w0 + w1) by the 8-bit reciprocal,
// with the reference's i16 wraps
__device__ __forceinline__ int norm_weight(int w0, int w1,
                                           const int* inv_table) {
  const int total = wadd(w0, w1);
  const int b = bit_length(total) - 8;
  const int sh = b > 0 ? b : 0;
  const int inv = 1 + inv_table[(total >> sh) & 0xFF];
  const int num = (w0 >> sh) << 8;
  const int hi = (inv >> 12) * num;
  const int lo = (inv & 0xFFF) * num;
  const int q16 = wrap16((uint32_t)((hi + (lo >> 12)) >> 12));
  return wrap16((uint32_t)q16 << 7);
}

// weights._compute_new_weight: one model's weight after the step
__device__ __forceinline__ int new_weight(int prob_i, int p1, int w_i) {
  const int error = (int)((uint32_t)(1 << 15) - (uint32_t)p1);
  const int log_geo = bit_length(wmul(p1, error));
  const int adj = sra(wmul(error, (int)((uint32_t)prob_i - (uint32_t)p1)),
                      log_geo - 15);
  const int s = wadd(w_i, adj);
  return s < 1 ? 1 : (s > kWeightMax ? kWeightMax : s);
}

// weights.update on (w0, w1, norm weight), in place: prob0 the coded
// symbol's freq under the cm row, prob1 under the nibble row, p1 under
// the mixed row that coded it
__device__ __forceinline__ void update_weights(int& w0, int& w1, int& w2,
                                               int prob0, int prob1, int p1,
                                               const int* inv_table) {
  // both weights to 24 bits where either has more (no branch: sh is 0
  // below 2^24)
  const int l0 = bit_length(w0), l1 = bit_length(w1);
  const int s = (l0 > l1 ? l0 : l1) - 24;
  const int sh = s > 0 ? s : 0;
  const int a = w0 >> sh, b = w1 >> sh;
  w0 = new_weight(prob0, p1, a);
  w1 = new_weight(prob1, p1, b);
  w2 = norm_weight(w0, w1, inv_table);
}

}  // namespace adaptive
