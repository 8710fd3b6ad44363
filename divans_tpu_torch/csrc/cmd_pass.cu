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
// Design.  One thread block per lane, the lane's whole state in shared
// memory for the whole stream: the model (256 rows of 16 int32, 16 KiB),
// two chunks' count histograms (2 x 16 KiB) and the row speeds (2 KiB);
// 51,200 bytes of dynamic shared memory.  The TPU kernel's block-diagonal
// tiles, bf16 hi/lo matmuls for the row fetch and the histogram, and its
// f32-reciprocal division are not carried over: a step reads three
// entries of its row (sym-1, sym, 15) straight from shared memory, counts
// with a shared-memory atomicAdd (integer, order-free) and divides with
// the integer unit.  Threads 0..S-1 code the chunk's S steps (the model
// is frozen within a chunk, so steps are independent); then thread r
// commits row r (R <= 256 = blockDim) and clears its old counts, and the
// renorm runs per row ("while this row is over": a pass leaves a row
// under its limit unchanged, so this equals the reference's "while any
// row is over").  Rows R..255 are never committed: a step whose row lies
// there (outside the contract) reads CDF_INIT and writes counts no one
// reads, so the kernel never touches memory outside its lane.  Two
// barriers a chunk.
//
// What bounds it.  Per step ~90 integer operations (the three loads, two
// exact divisions of ~25 instructions each, the atomic, the stores), per
// chunk a commit of R x 16 entries (~6 operations an entry, plus the
// renorm passes); 2 B in and 8 B out a step, so operations bound it on
// paper.  The chain that bounds a block is the chunk loop: two barriers
// and a commit per S = 64 steps, one block per lane, so a batch of B
// frames fills B SMs.  More lanes per launch or a cheaper commit are
// later work; the output does not depend on how lanes map to blocks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 256;      // flat is 8 bits
constexpr int kThreads = 256;      // >= S (cmd chunk <= 256) and >= R
constexpr int kMaxRenorm = 24;
constexpr int kSmemInts = 3 * kMaxRows * 16 + 2 * kMaxRows;

__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ int shl32(int a, int s) {
  return (int)((uint32_t)a << s);
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

__global__ void cmd_pass_kernel(const uint16_t* __restrict__ packed, int n,
                                const int32_t* __restrict__ inc_all,
                                const int32_t* __restrict__ lim_all,
                                const int32_t* __restrict__ n_steps_all,
                                int32_t* __restrict__ starts,
                                int32_t* __restrict__ freqs, int num_rows,
                                int s) {
  extern __shared__ int smem[];
  int* model = smem;                                // [256][16]
  int* cnt = model + kMaxRows * 16;                 // [2][256][16]
  int* inc = cnt + 2 * kMaxRows * 16;               // [256]
  int* lim = inc + kMaxRows;                        // [256]

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  // a count past the row (or below 0) is clamped: the lane's outputs
  // stay inside its row whatever the caller passes
  const int n_steps = min(max(n_steps_all[lane], 0), n);
  const int n_chunks = (n_steps + s - 1) / s;
  const uint16_t* in = packed + (size_t)lane * n;
  int32_t* st_out = starts + (size_t)lane * n;
  int32_t* fr_out = freqs + (size_t)lane * n;

  for (int i = tid; i < kMaxRows * 16; i += blockDim.x) {
    model[i] = 4 * ((i & 15) + 1);   // CDF_INIT
    cnt[i] = 0;
    cnt[kMaxRows * 16 + i] = 0;
  }
  for (int r = tid; r < kMaxRows; r += blockDim.x) {
    inc[r] = r < num_rows ? inc_all[(size_t)lane * num_rows + r] : 0;
    lim[r] = r < num_rows ? lim_all[(size_t)lane * num_rows + r] : 0x8000;
  }
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    int* cnt_new = cnt + (c & 1) * kMaxRows * 16;
    int* cnt_old = cnt + ((c + 1) & 1) * kMaxRows * 16;
    // ---- code step t of the chunk against the frozen snapshot
    if (tid < s) {
      const int t = c * s + tid;
      const uint32_t p = t < n_steps ? (uint32_t)in[t] : 0u;
      const int flat = p & 0xFF, sym = (p >> 8) & 15;
      const bool act = (p >> 12) & 1;
      const int ip = sym > 0 ? sym - 1 : 0;
      int c_prev, c_sym, c_max;
      if (act) {
        const int* row = model + flat * 16;
        c_prev = row[ip];
        c_sym = row[sym];
        c_max = row[15];
        atomicAdd(cnt_new + flat * 16 + sym, 1);
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
      } else if (t < n) {
        st_out[t] = 0;
        fr_out[t] = 0;
      }
    }
    __syncthreads();

    // ---- commit chunk c-1's pend (the other buffer), then clear it
    for (int r = tid; r < num_rows; r += blockDim.x) {
      int* row = model + r * 16;
      int* cr = cnt_old + r * 16;
      const int ir = inc[r];
      int v[16];
      int cum = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        cum += cr[i];
        v[i] = row[i] + mul32(ir, cum);
        cr[i] = 0;
      }
      const int lim_eff = cum > 0 ? lim[r] : 0x8000;
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
// -> starts, freqs int32[B, n].  One block of 256 threads per lane;
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
  cmd_pass_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)packed, n, (const int32_t*)inc, (const int32_t*)lim,
      (const int32_t*)n_steps, (int32_t*)starts, (int32_t*)freqs, num_rows,
      s);
  return (int)cudaGetLastError();
}
