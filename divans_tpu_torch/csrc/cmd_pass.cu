// Deferred-profile cmd-stream model pass of the encode, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel divans_tpu/codec/pallas_cmd_pass.py:144
// (_make_kernel, launched by _cmd_pass_call at :298), the bit-exact twin
// of the XLA pass jax_engine.model_pass_deferred_cmd (:321).  Contract,
// per lane (one frame's cmd stream against a fresh model of R rows):
//   * every row is a 16-entry CDF starting at CDF_INIT (4, 8..64); a
//     step packs its row (flat, 8 bits), its symbol (4 bits) and whether
//     it adapts (act, 1 bit) as flat | value<<8 | act<<12;
//   * every step of chunk c (S steps) is coded against the snapshot
//     committed through chunk c-2: an active step fetches its row, an
//     inactive one codes against CDF_INIT; either gives
//     cdf16.sym_to_start_freq (start, freq) of its symbol;
//   * at the end of chunk c, chunk c-1's pend commits: add = inc[r] *
//     cumsum(cnt[r]) over the row's symbol counts, then renorm passes
//     x -> (x+i+1) - ((x+i+1)>>2) on entry i while row[15] >= lim_eff (at
//     most 24), lim_eff = lim[r] for a row counted in c-1, else 0x8000;
//     chunk c's counts become the next pend.  No mixer, no weights: the
//     cmd stream never mixes.  Speeds are per row, constant in a lane
//     (the caller checks: codec/cmd_pass.cmd_speeds_from_rows).
// A lane's step count is clamped to [0, N].  int32 with the
// reference's wraps: products and shifts in uint32.
//
// Design.  One thread block per lane, 256 + S threads, the lane's whole
// state in shared memory for the whole stream: two copies of the model
// (256 rows of 16 int32, each padded to 20 so that a thread's 16-byte
// accesses to its row meet no bank conflict: 2 x 20 KiB), two chunks'
// count histograms (2 x 20 KiB), the row speeds (2 KiB) and four 256-bit
// row masks (128 B); 84,096 bytes of dynamic shared memory.  The TPU kernel's
// block-diagonal tiles, bf16 hi/lo matmuls for the row fetch and the
// histogram, and its f32-reciprocal division are not carried over.
// A chunk is one phase and one barrier: threads 256..256+S-1 code chunk
// c's steps while threads 0..255 commit chunk c-1's counts, one row a
// thread.  The two never meet: the steps read the snapshot through c-2
// from one copy of the model, and the commit writes the snapshot
// through c-1 into the other, which the next chunk reads.
//   * A step (the model is frozen within a chunk, so steps are
//     independent) reads three entries of its row (sym-1, sym, 15)
//     straight from shared memory, counts with a shared atomicAdd, marks
//     its row in the chunk's `counted` mask (atomicOr) and divides in
//     double precision (an exact floor division: one reciprocal for the
//     two numerators, a remainder test); its packed step was loaded two
//     chunks ahead.
//   * Thread r commits row r only where the rule can change it: a row
//     chunk c-1 did not count commits with lim_eff = 0x8000, so it
//     changes only if its entry 15 is at or above 0x8000, known from its
//     own last commit (the `over` mask).  A commit adds inc[r] times the
//     cumulative counts, then renorm passes while entry 15 >= lim_eff
//     (the per-row rule equals the reference's "while any row is over":
//     a pass leaves a row under its limit unchanged), and clears the
//     row's counts.  A row committed into the other copy one chunk
//     earlier and not now is copied across, so the copy the next chunk
//     reads is whole: it takes the commit's own path, since it has no
//     counts and, not being over, meets no renorm pass.  Warp w owns rows 32w..32w+31, the bits of word w
//     of the masks: a warp with nothing to do skips the phase, and a
//     committing warp sets its `over` word anew by a ballot.
// Rows R..255 are never committed: a step whose row lies there (outside
// the contract) reads CDF_INIT and writes counts no one reads, so the
// kernel never touches memory outside its lane.
//
// What bounds it.  Per step ~90 integer operations (the three loads, two
// exact floor divisions, the two atomics, the stores), per counted row a
// commit of ~100 (16 entries of ~6, plus the renorm passes), per other
// row one test of a mask bit; 2 B in and 8 B out a step, so operations
// bound it on paper.  The chain that bounds a block is the chunk loop:
// the longer of a step and a row's commit, and one barrier, per S = 64
// steps; one block per lane, so a batch of B frames fills B SMs; the
// output does not depend on how lanes map to blocks.
#include <cstdint>
#include <cuda_runtime.h>

#include "floor_div.cuh"

namespace {

constexpr int kMaxRows = 256;      // flat is 8 bits; one commit thread each
constexpr int kMaxChunk = 256;     // one step thread each
constexpr int kMaxRenorm = 24;
constexpr int kWords = kMaxRows / 32;   // a row mask
// a row of the models and counts takes 20 ints, so that a thread's
// 16-byte accesses to its own row meet no bank conflict
constexpr int kRowInts = 20;
constexpr int kSmemInts = 4 * kMaxRows * kRowInts + 2 * kMaxRows   // models,
                          + 4 * kWords;        // counts, speeds; masks
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

// (start, freq) of `sym` from the three CDF entries it needs: c_prev =
// cdf[sym-1] (unused for sym 0), c_sym = cdf[sym], c_max = cdf[15].
__device__ __forceinline__ void start_freq(int c_prev, int c_sym, int c_max,
                                           int sym, int& start, int& freq) {
  const int m = max(c_max, 1);
  const double rcp = 1.0 / (double)m;
  const int r_sym = floor_div(shl32(c_sym, 15), m, rcp);
  const int r_prev = sym > 0 ? floor_div(shl32(c_prev, 15), m, rcp) : 0;
  start = r_prev + 1;
  freq = r_sym - start;
}

__global__ void __launch_bounds__(kMaxRows + kMaxChunk)
cmd_pass_kernel(const uint16_t* __restrict__ packed, int n,
                const int32_t* __restrict__ inc_all,
                const int32_t* __restrict__ lim_all,
                const int32_t* __restrict__ n_steps_all,
                int32_t* __restrict__ starts, int32_t* __restrict__ freqs,
                int num_rows, int s) {
  extern __shared__ __align__(16) int smem[];
  int* model = smem;                                // [2][256][20]
  int* cnt = model + 2 * kMaxRows * kRowInts;       // [2][256][20]
  int* inc = cnt + 2 * kMaxRows * kRowInts;         // [256]
  int* lim = inc + kMaxRows;                        // [256]
  unsigned* counted = (unsigned*)(lim + kMaxRows);  // [2][8] rows counted
  unsigned* over = counted + 2 * kWords;            // [8] entry 15 >= 0x8000
  unsigned* moved = over + kWords;                  // [8] last committed

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  // a count past the row (or below 0) is clamped: the lane's outputs
  // stay inside its row whatever the caller passes
  const int n_steps = min(max(n_steps_all[lane], 0), n);
  const int n_chunks = (n_steps + s - 1) / s;
  const uint16_t* in = packed + (size_t)lane * n;
  int32_t* st_out = starts + (size_t)lane * n;
  int32_t* fr_out = freqs + (size_t)lane * n;

  for (int i = tid; i < 2 * kMaxRows * kRowInts; i += blockDim.x) {
    model[i] = 4 * (i % kRowInts + 1);   // CDF_INIT (and 4 padding ints)
    cnt[i] = 0;
  }
  for (int r = tid; r < kMaxRows; r += blockDim.x) {
    inc[r] = r < num_rows ? inc_all[(size_t)lane * num_rows + r] : 0;
    lim[r] = r < num_rows ? lim_all[(size_t)lane * num_rows + r] : 0x8000;
  }
  if (tid < 4 * kWords) counted[tid] = 0;   // counted, over and moved
  // a step thread's steps of chunks 0 and 1
  const int j = tid - kMaxRows;
  uint32_t p_next = 0u, p_after = 0u;
  if (j >= 0) {
    p_next = j < n_steps ? (uint32_t)in[j] : 0u;
    p_after = s + j < n_steps ? (uint32_t)in[s + j] : 0u;
  }
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int par = c & 1, pp = par ^ 1;
    const int* snap = model + par * kMaxRows * kRowInts;  // through c-2
    int* next = model + pp * kMaxRows * kRowInts;         // through c-1
    if (j >= 0) {
      // ---- code step t of the chunk against the frozen snapshot
      int* cnt_new = cnt + par * kMaxRows * kRowInts;
      const int t = c * s + j;
      const uint32_t p = p_next;
      const int t_load = t + 2 * s;
      p_next = p_after;
      p_after = t_load < n_steps ? (uint32_t)in[t_load] : 0u;
      const int flat = p & 0xFF, sym = (p >> 8) & 15;
      const bool act = (p >> 12) & 1;
      const int ip = sym > 0 ? sym - 1 : 0;
      int c_prev, c_sym, c_max;
      if (act) {
        const int* row = snap + flat * kRowInts;
        c_prev = row[ip];
        c_sym = row[sym];
        c_max = row[15];
        atomicAdd(cnt_new + flat * kRowInts + sym, 1);
        atomicOr(counted + par * kWords + (flat >> 5), 1u << (flat & 31));
      } else {
        c_prev = 4 * (ip + 1);
        c_sym = 4 * (sym + 1);
        c_max = 64;
      }
      int start, freq;
      start_freq(c_prev, c_sym, c_max, sym, start, freq);
      if (t < n_steps) {
        st_out[t] = start;
        fr_out[t] = freq;
      } else {
        st_out[t] = 0;
        fr_out[t] = 0;
      }
    } else {
      // ---- commit row tid where chunk c-1 counted it or its entry 15
      // is at or above 0x8000, into the other copy; carry the rows the
      // last chunk committed and this one does not
      int* cnt_old = cnt + pp * kMaxRows * kRowInts;
      const int w = tid >> 5, l = tid & 31;
      const unsigned live_rows =
          num_rows >= 32 * (w + 1) ? kFull
          : num_rows > 32 * w ? (1u << (num_rows - 32 * w)) - 1u : 0u;
      const unsigned todo = (counted[pp * kWords + w] | over[w]) & live_rows;
      const unsigned carry = moved[w] & ~todo;
      unsigned high_rows = 0;
      if ((todo | carry) != 0) {            // warp-uniform
        const int4* from =
            reinterpret_cast<const int4*>(snap + tid * kRowInts);
        int4* to = reinterpret_cast<int4*>(next + tid * kRowInts);
        bool high = false;
        if (((todo | carry) >> l) & 1u) {
          int4* cr = reinterpret_cast<int4*>(cnt_old + tid * kRowInts);
          int v[16], cum[16];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int4 m = from[q], k = cr[q];
            v[4 * q] = m.x, v[4 * q + 1] = m.y, v[4 * q + 2] = m.z,
            v[4 * q + 3] = m.w;
            cum[4 * q] = k.x, cum[4 * q + 1] = k.y, cum[4 * q + 2] = k.z,
            cum[4 * q + 3] = k.w;
            cr[q] = make_int4(0, 0, 0, 0);
          }
          // the cumulative counts in 4 levels of independent adds (a
          // 15-add chain is longer)
#pragma unroll
          for (int i = 15; i >= 1; --i) cum[i] += cum[i - 1];
#pragma unroll
          for (int i = 15; i >= 2; --i) cum[i] += cum[i - 2];
#pragma unroll
          for (int i = 15; i >= 4; --i) cum[i] += cum[i - 4];
#pragma unroll
          for (int i = 15; i >= 8; --i) cum[i] += cum[i - 8];
          const int ir = inc[tid];
#pragma unroll
          for (int i = 0; i < 16; ++i) v[i] = add32(v[i], mul32(ir, cum[i]));
          const int lim_eff = cum[15] > 0 ? lim[tid] : 0x8000;
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
      }
      __syncwarp();                         // the warp has read its words
      if (l == 0) {
        over[w] = (over[w] & ~todo) | high_rows;
        counted[pp * kWords + w] = 0;       // chunk c+1's mask
        moved[w] = todo;
      }
    }
    __syncthreads();
  }
  // steps past the lane's last chunk
  for (int i = n_chunks * s + tid; i < n; i += blockDim.x) {
    st_out[i] = 0;
    fr_out[i] = 0;
  }
}

}  // namespace

// packed uint16[B, n], inc and lim int32[B, num_rows], n_steps int32[B]
// -> starts, freqs int32[B, n].  One block of 256 + s threads per lane;
// num_rows <= 256, s <= 256.  Launches on `stream` and returns
// cudaGetLastError() (or the error of the shared-memory attribute).
extern "C" int dtpu_cmd_pass(const void* packed, int n, const void* inc,
                             const void* lim, const void* n_steps,
                             void* starts, void* freqs, int B, int num_rows,
                             int s, void* stream) {
  const int smem = kSmemInts * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      cmd_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cmd_pass_kernel<<<B, kMaxRows + s, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)packed, n, (const int32_t*)inc, (const int32_t*)lim,
      (const int32_t*)n_steps, (int32_t*)starts, (int32_t*)freqs, num_rows,
      s);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a launch (bytes).
extern "C" int dtpu_cmd_pass_smem() { return kSmemInts * (int)sizeof(int); }
