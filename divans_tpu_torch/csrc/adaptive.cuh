// The adaptive profile's integer arithmetic for one thread, shared by the
// per-nibble model pass (model_pass.cu) and the decode scan
// (scan_decode.cu): cdf16's blend, average, (start, freq) and offset ->
// symbol, and the two-model mixer's update, each exactly as the
// reference's XLA programs compute it on int32 (divans_tpu/probability/
// cdf16.py, weights.py):
//   * a row is 16 int16 entries, 32 bytes, moved as two 16-byte words;
//   * every sum and product that can leave int32 is taken in uint32 and
//     cast back (XLA's int32 wraps), every i16 cast wraps;
//   * `//` is floor division, and a divisor of 0 or below (a row whose
//     max wrapped) divides as XLA does: by 0 it gives -1 for 0 and -2
//     otherwise;
//   * an arithmetic shift by an amount outside [0, 31] fills the word
//     with the sign, as XLA's and numpy's do.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "floor_div.cuh"

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

// floor(a / b) for |a| <= 2^30 and any int32 b, as XLA's jnp `//`
__device__ __forceinline__ int xdiv(int a, int b, double rcp) {
  if (b > 0) return floor_div(a, b, rcp);
  if (b == 0) return a == 0 ? -1 : -2;
  return floor_div(-a, -b, -rcp);
}

__device__ __forceinline__ double xrcp(int b) {
  return b != 0 ? 1.0 / (double)b : 0.0;
}

// a row of 16 int16 at `row` of a model of 16-entry rows, into ints
__device__ __forceinline__ void load_row(const int16_t* model, int row,
                                         int out[16]) {
  const int4* p = reinterpret_cast<const int4*>(model + (size_t)row * 16);
  const int4 lo = p[0], hi = p[1];
  const int w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    out[2 * k] = (int)(int16_t)(uint16_t)((uint32_t)w[k] & 0xFFFFu);
    out[2 * k + 1] = w[k] >> 16;
  }
}

__device__ __forceinline__ void store_row(int16_t* model, int row,
                                          const int in[16]) {
  int w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k] = (int)(((uint32_t)in[2 * k] & 0xFFFFu)
                 | ((uint32_t)in[2 * k + 1] << 16));
  }
  int4* p = reinterpret_cast<int4*>(model + (size_t)row * 16);
  p[0] = make_int4(w[0], w[1], w[2], w[3]);
  p[1] = make_int4(w[4], w[5], w[6], w[7]);
}

// The largest model a block keeps in shared memory (R x 32 B): a block's
// 232,448 B less room for its static shared memory.  A larger model (mix,
// 22,859 rows) takes a global scratch slab of R x 32 B per frame.
constexpr int kMaxShared = 231424;

// Frame b's model, in shared memory or in its share of the scratch slab
// when there is one, every row set to CDF_INIT (4, 8, ..., 64) by the
// block's threads, two 16-byte words a row; the caller syncs the block.
__device__ __forceinline__ int16_t* init_model(int4* smem, int16_t* scratch,
                                               int b, int num_rows) {
  int16_t* model = scratch == nullptr
      ? reinterpret_cast<int16_t*>(smem)
      : scratch + (size_t)b * num_rows * 16;
  // CDF_INIT as packed int16 pairs
  const int4 lo = make_int4(4 | 8 << 16, 12 | 16 << 16, 20 | 24 << 16,
                            28 | 32 << 16);
  const int4 hi = make_int4(36 | 40 << 16, 44 | 48 << 16, 52 | 56 << 16,
                            60 | 64 << 16);
  int4* m4 = reinterpret_cast<int4*>(model);
  for (int i = threadIdx.x; i < 2 * num_rows; i += blockDim.x) {
    m4[i] = (i & 1) ? hi : lo;
  }
  return model;
}

// Both mixers' weights set to (1, 1, 2^14), by the block's first threads.
__device__ __forceinline__ void init_weights(int weights[2][3]) {
  if (threadIdx.x < 2) {
    weights[threadIdx.x][0] = 1;
    weights[threadIdx.x][1] = 1;
    weights[threadIdx.x][2] = kNormWeightInit;
  }
}

// A launch's dynamic shared memory: the model's R x 32 B, or 0 with a
// scratch slab; lifts the kernel's limit where it passes 48 KiB.
template <typename Kernel>
inline cudaError_t model_smem(Kernel kernel, int num_rows, bool slab,
                              size_t* smem) {
  *smem = slab ? 0 : (size_t)num_rows * 32;
  if (*smem > (size_t)kMaxShared) return cudaErrorInvalidValue;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// entry i of a[] for i in [0, 15] (a select chain: no local memory)
__device__ __forceinline__ int pick(const int a[16], int i) {
  int out = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) out = (k == i) ? a[k] : out;
  return out;
}

// cdf16.blend: bump entries >= sym by inc; renorm when entry 15 >= lim
__device__ __forceinline__ void blend(int c[16], int sym, int inc, int lim) {
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = wrap16((uint32_t)c[i] + (i >= sym ? (uint32_t)inc : 0u));
  if (c[15] >= lim) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int cb = wrap16((uint32_t)c[i] + (uint32_t)(i + 1));
      c[i] = wrap16((uint32_t)cb - (uint32_t)(cb >> 2));
    }
  }
}

// cdf16.average of one entry: mix * a + (1 - mix) * b in 15-bit fixed
// point, each side first scaled by the other's max
struct Mix {
  int amax, bmax, shift, rate, inv;
};

__device__ __forceinline__ Mix mix_of(int amax, int bmax, int rate) {
  Mix m;
  m.amax = amax;
  m.bmax = bmax;
  const int b = bit_length(amax * bmax) - 15;
  m.shift = b > 0 ? b : 0;
  m.rate = rate;
  m.inv = (1 << 15) - rate;
  return m;
}

__device__ __forceinline__ int average(const Mix& m, int a, int b) {
  const int ra = (a * m.bmax) >> m.shift;
  const int rb = (b * m.amax) >> m.shift;
  const int s = (int)((uint32_t)ra * (uint32_t)m.rate
                      + (uint32_t)rb * (uint32_t)m.inv + 1u);
  return wrap16((uint32_t)(s >> 15));
}

// cdf16.sym_to_start_freq from the row's entries sym - 1 (0 for sym 0),
// sym and 15: start = floor(c_prev << 15 / max) + 1 (1 for sym 0), freq
// = floor(c_sym << 15 / max) - start
__device__ __forceinline__ void start_freq(int c_prev, int c_sym, int maxv,
                                           int sym, int* start, int* freq) {
  const double rcp = xrcp(maxv);
  const int r_sym = xdiv(shl(c_sym, kLog2Scale), maxv, rcp);
  const int r_prev = sym > 0 ? xdiv(shl(c_prev, kLog2Scale), maxv, rcp) : 0;
  *start = r_prev + 1;
  *freq = (int)((uint32_t)r_sym - (uint32_t)r_prev - 1u);
}

__device__ __forceinline__ int freq_of(const int c[16], int sym) {
  int start, freq;
  start_freq(pick(c, sym - 1), pick(c, sym), c[15], sym, &start, &freq);
  return freq;
}

// cdf16.offset_to_sym: #{i < 15 : c[i] <= (offset * max) >> 15}
__device__ __forceinline__ int offset_to_sym(const int c[16], int offset) {
  const int resc = (offset * c[15]) >> kLog2Scale;
  int n = 0;
#pragma unroll
  for (int i = 0; i < 15; ++i) n += c[i] <= resc ? 1 : 0;
  return n;
}

// weights.norm_weight: 15-bit w0 / (w0 + w1) by the 8-bit reciprocal,
// with the reference's i16 wraps
__device__ __forceinline__ int norm_weight(int w0, int w1) {
  const int total = wadd(w0, w1);
  const int b = bit_length(total) - 8;
  const int sh = b > 0 ? b : 0;
  const int total8 = total >> sh;
  const int inv = 1 + floor_div(1 << 24, total8);
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

// weights.update on w = (w0, w1, norm weight), in place: prob0 the coded
// symbol's freq under the cm row, prob1 under the nibble row, p1 under
// the mixed row that coded it
__device__ __forceinline__ void update_weights(int w[3], int prob0, int prob1,
                                               int p1) {
  int w0 = w[0], w1 = w[1];
  if (((w0 | w1) & 0x7F000000) != 0) {
    const int l0 = bit_length(w0), l1 = bit_length(w1);
    const int b = (l0 > l1 ? l0 : l1) - 24;
    const int sh = b > 0 ? b : 0;
    w0 >>= sh;
    w1 >>= sh;
  }
  w[0] = new_weight(prob0, p1, w0);
  w[1] = new_weight(prob1, p1, w1);
  w[2] = norm_weight(w[0], w[1]);
}

}  // namespace adaptive
