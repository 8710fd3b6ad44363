// Wide rANS (rans32) reverse encode, two warps per lane, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel divans_tpu/ans/pallas_kernels.py:57
// (_encode_kernel, launched by encode_lanes_pallas at :88).  Same
// contract, per lane, from t = N-1 down to 0, starting from the state
// 2^15 (coder_np.ENC_START_STATE):
//   words[t] = state & 0xFFFF (before symbol t, whether emitted or not)
//   valid = t < count;  freq = max(freqs[t], 1)
//   flags[t] = valid && state >= freq << 16;  if so state >>= 16
//   if valid: state = (state // freq) << 15 + state % freq + starts[t]
// and states[lane] = the final state.  int32 semantics throughout, as
// the reference's: the shift and the update wrap (done in uint32 and
// cast back), the division is floor division.
//
// Design.  Two warps per lane (a block), which walk the lane's symbols
// backward in tiles of 256 steps; only the state update is serial, so
// everything else is taken off the chain and done by the second warp
// while the first codes the previous tile:
//   * loads: the producer warp copies the next tile's starts and freqs
//     into a double-buffered ring in shared memory with cp.async (16 B a
//     thread where the row is 16-byte aligned, else 4 B), issued a tile
//     ahead, so each copy runs under the chain;
//   * division: for each step of a tile the producer computes, in
//     parallel, max(freq, 1), the renorm bound freq << 16 and the magic
//     number m = ceil(2^(31+l) / freq), l = ceil(log2 freq), so that
//     floor(x / freq) = umulhi(2x, m) >> l for every 0 <= x < 2^31
//     (Granlund and Montgomery: x * m / 2^(31+l) exceeds x / freq by less
//     than 1/freq).  The consumer's chain is then a compare, a select, a
//     multiply-high, a shift and the update state = x + start + q *
//     (2^15 - freq), one 16-byte shared-memory load a step;
//   * the fast chain needs x >= 0 at every step.  A tile whose steps all
//     have 1 <= freq <= 2^15, start >= 0 and start + freq <= 2^15 (every
//     valid stream's) keeps a state in [0, 2^31) there, so the producer
//     checks each tile once (a warp vote) and the consumer takes the
//     fast chain when the tile passes and its state is >= 0, else an
//     exact signed floor division a step;
//   * stores: the chain writes each step's word and flag into shared
//     memory, and the producer stores the tile to the rows a tile later
//     with 16-byte stores where the row is aligned.  Columns past the
//     count keep the start state: both warps fill them first.
// One barrier a tile hands the buffers over.
//
// What bounds it.  The serial chain per symbol, ~5 dependent integer
// instructions and one shared-memory load that does not depend on the
// state; on paper the bytes (8 B in, 3 B out a symbol) bound it far
// below that.  A batch has tens of lanes, so tens of blocks run on the
// card; lanes from several batches per launch, or interleaved states per
// lane (a change of the wire format), are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 2 * kWarp;   // warp 0: the chain; warp 1: the rest
constexpr int kTile = 256;            // steps a tile (a multiple of 16)

// The state-free part of one step, computed ahead of the chain.
struct __align__(16) Step {
  int32_t bound;    // freq << 16, wrapped to int32
  uint32_t magic;   // ceil(2^(31+l) / freq), l = ceil(log2 freq)
  int32_t start;
  int32_t freq;     // max(freq, 1)
};

// floor(a / b) for b >= 1 (the reference's `//`).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b) != 0 && a < 0) --q;
  return q;
}

__device__ __forceinline__ int ceil_log2(int32_t f) {   // f >= 1
  return 32 - __clz(f - 1);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait for all but the newest group of this thread's copies
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The warp starts copying n ints of a row into shared memory.  With vec,
// in 16 B pieces: the row and src are 16-byte aligned and the row's
// length is a multiple of 4, so a last piece past n stays in the row.
__device__ __forceinline__ void fetch(int32_t* dst, const int32_t* src, int n,
                                      bool vec, int lane) {
  if (vec) {
    for (int i = 4 * lane; i < n; i += 4 * kWarp) cp_async16(dst + i, src + i);
  } else {
    for (int i = lane; i < n; i += kWarp) cp_async4(dst + i, src + i);
  }
}

// The warp stores n staged elements to dst, 16 B a thread where dst is
// 16-byte aligned (src, in shared memory, always is).
template <typename E>
__device__ __forceinline__ void store(E* dst, const E* src, int n, int lane) {
  constexpr int kVec = 16 / sizeof(E);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nv = n / kVec;
    for (int i = lane; i < nv; i += kWarp) {
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    }
    done = nv * kVec;
  }
  for (int i = done + lane; i < n; i += kWarp) dst[i] = src[i];
}

// Code steps n-1 .. 0 of a tile backward from `state`; the words before
// each step and the flags go to wb and fb.  Fast: every step keeps the
// state in [0, 2^31), so the magic-number quotient is exact.
template <bool kFast>
__device__ __forceinline__ int32_t code_tile(const Step* prep, int n,
                                             int32_t state, int16_t* wb,
                                             int8_t* fb) {
#pragma unroll 4
  for (int i = n - 1; i >= 0; --i) {
    const Step p = prep[i];
    wb[i] = (int16_t)(state & 0xFFFF);
    const bool flag = state >= p.bound;
    fb[i] = flag ? 1 : 0;
    const int32_t x = flag ? state >> 16 : state;
    if (kFast) {
      const uint32_t q = __umulhi((uint32_t)x << 1, p.magic) >>
                         ceil_log2(p.freq);
      state = (int32_t)((uint32_t)x + (uint32_t)p.start +
                        q * (uint32_t)(32768 - p.freq));
    } else {
      const int32_t q = floor_div(x, p.freq);
      state = (int32_t)(((uint32_t)q << 15) + (uint32_t)(x - q * p.freq) +
                        (uint32_t)p.start);
    }
  }
  return state;
}

__global__ void __launch_bounds__(kThreads) rans_encode_kernel(
    const int32_t* __restrict__ starts, const int32_t* __restrict__ freqs,
    const int32_t* __restrict__ counts, int16_t* __restrict__ words,
    int8_t* __restrict__ flags, int32_t* __restrict__ states, int B, int N) {
  __shared__ __align__(16) int32_t raw[2][2][kTile];   // [ring][starts, freqs]
  __shared__ Step prep[2][kTile];
  __shared__ __align__(16) int16_t wbuf[2][kTile];
  __shared__ __align__(16) int8_t fbuf[2][kTile];
  __shared__ int tile_ok[2];
  const int l = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int32_t* st = starts + (size_t)l * N;
  const int32_t* fr = freqs + (size_t)l * N;
  int16_t* wo = words + (size_t)l * N;
  int8_t* fo = flags + (size_t)l * N;
  const int c = min(max(counts[l], 0), N);
  const bool vec = N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(starts) |
                     reinterpret_cast<uintptr_t>(freqs)) & 15) == 0;
  // past the count the state stays 2^15: word 0x8000, no flag
  for (int t = c + threadIdx.x; t < N; t += kThreads) {
    wo[t] = (int16_t)0x8000;
    fo[t] = 0;
  }
  // tile k (k = 0 the top one) holds steps [lo(k), lo(k) + len(k))
  const int n_tiles = (c + kTile - 1) / kTile;
  auto lo = [&](int k) { return (n_tiles - 1 - k) * kTile; };
  auto len = [&](int k) { return min(kTile, c - lo(k)); };
  if (warp == 1 && n_tiles > 0) {
    fetch(raw[0][0], st + lo(0), len(0), vec, lane);
    fetch(raw[0][1], fr + lo(0), len(0), vec, lane);
    cp_async_commit();
  }
  int32_t state = 1 << 15;   // the chain's, in warp 0's lane 0
  // iteration it: the producer prepares tile it and stores tile it - 2,
  // the chain codes tile it - 1
  for (int it = 0; it < n_tiles + 2; ++it) {
    if (warp == 1) {
      if (it < n_tiles) {
        const int b = it & 1;
        if (it + 1 < n_tiles) {
          fetch(raw[b ^ 1][0], st + lo(it + 1), len(it + 1), vec, lane);
          fetch(raw[b ^ 1][1], fr + lo(it + 1), len(it + 1), vec, lane);
        }
        cp_async_commit();   // an empty group on the last tile keeps the count
        cp_async_wait();
        __syncwarp();
        bool ok = true;
        for (int i = lane; i < len(it); i += kWarp) {
          const int32_t f = max(raw[b][1][i], 1);
          const int32_t s0 = raw[b][0][i];
          const int lg = ceil_log2(f);
          prep[b][i] = {(int32_t)((uint32_t)f << 16),
                        (uint32_t)(((1ull << (31 + lg)) + f - 1) / f), s0, f};
          ok = ok && f <= 32768 && s0 >= 0 && s0 <= 32768 - f;
        }
        ok = __all_sync(0xffffffffu, ok);
        if (lane == 0) tile_ok[b] = ok;
      }
      if (it >= 2) {
        const int k = it - 2;
        store(wo + lo(k), wbuf[k & 1], len(k), lane);
        store(fo + lo(k), fbuf[k & 1], len(k), lane);
      }
    } else if (lane == 0 && it >= 1 && it <= n_tiles) {
      const int k = it - 1;
      const int b = k & 1;
      state = tile_ok[b] && state >= 0
                  ? code_tile<true>(prep[b], len(k), state, wbuf[b], fbuf[b])
                  : code_tile<false>(prep[b], len(k), state, wbuf[b],
                                     fbuf[b]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) states[l] = state;
}

}  // namespace

// starts, freqs int32[B, N], counts int32[B] -> words int16[B, N],
// flags int8[B, N], states int32[B].  One block of two warps per lane.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dtpu_rans_encode(const void* starts, const void* freqs,
                                const void* counts, void* words, void* flags,
                                void* states, int B, int N, void* stream) {
  rans_encode_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)starts, (const int32_t*)freqs, (const int32_t*)counts,
      (int16_t*)words, (int8_t*)flags, (int32_t*)states, B, N);
  return (int)cudaGetLastError();
}
