// Generic deferred model pass of the encode, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel divans_tpu/codec/pallas_model.py:100
// (_kernel, launched by model_pass_deferred_pallas at :301), the bit-exact
// twin of the XLA pass jax_engine.model_pass_deferred (:209) and of the
// normative replay codec/deferred.replay_trace.  Contract, per lane (one
// stream against a fresh model of R rows and fresh mixer weights):
//   * a step is one row of the 10-column trace: flat, value, stream, inc,
//     lim, mix, which, cm_idx, cm_inc, cm_lim; every row is a 16-entry
//     CDF starting at CDF_INIT (4, 8..64), the weights of each mixer
//     "which" (0, 1) start at (1, 1, 2^14);
//   * every step of chunk c (S steps) is coded against the snapshot
//     committed through chunk c-2: the row `flat`, mixed with the row
//     `cm_idx` where `mix` is set (cdf16.average(cm, nib, nw & 0xFFFF),
//     nw the norm weight of `which`), gives (start, freq) of `value`; a
//     mixing step also gives its two mixer adjustments
//     (deferred.weight_adjustments: w-independent, clamped to 2^21);
//   * a step records a hit (row flat, inc, lim) where inc != 0, and a
//     hit (row cm_idx, cm_inc, cm_lim) where it mixes and cm_inc != 0;
//   * at the end of chunk c, chunk c-1's hits commit, per row they
//     touched: row[i] += the inc of each hit with sym <= i, lim_eff =
//     floor(sum of the hits' lim / hits), then renorm passes x ->
//     (x+i+1) - ((x+i+1)>>2) on entry i while row[15] >= lim_eff (at
//     most 24); rows no hit touched stay as they are.  Each mixer's
//     weights take the chunk's summed adjustments (int32 wraparound):
//     clip to [1, 2^30-1], the >= 2^24 rescale, then norm_weight.
// A lane's step count is clamped to [0, N]; steps at and past it record
// nothing and write 0.  int32 with the reference's wraps: sums, products
// and shifts in uint32.  The wrapper checks that every live step's rows
// lie in [0, R), its value in [0, 16) and its which in {0, 1}.
//
// Design.  Kernels 3 and 4 keep a lane's model in shared memory; this
// one cannot: the rebased literal model has 4,370 rows (280 KB) in the
// stride profile and 20,865 (1.3 MB) in the mix profile, over a block's
// 227 KB.  So each lane owns a slab of global memory (`scratch`, 52 ints
// a row): the model [R][16], and for each chunk parity the pend of a row,
// its 16 per-symbol inc sums, its lim sum and its hits.  The rows a chunk
// touches stay in the 50 MB L2.  One block per lane loops over the
// lane's chunks; its threads take the chunk's steps.  Phase A: a step
// reads only the entries it needs (sym-1, sym and 15 of its row and of
// its cm row) from the frozen snapshot, writes (start, freq), adds its
// hits into the pend of parity c & 1 with global atomicAdds (integer,
// order-free); the thread whose add to a row's hit count returns 0
// appends the row to that parity's touched list in shared memory (at
// most 2S rows).  The four adjustment sums are warp-shuffle reductions
// and shared atomics.  Barrier, then phase B commits chunk c-1: threads
// walk its touched list, commit each row (prefix sum, lim_eff, renorm)
// and clear its pend; thread 0 commits the weights.  Barrier.  Only
// touched rows are committed and cleared, the normative rule (a dense
// pass over R rows would move 1.3 MB a chunk in the mix profile).  The
// slab is set up by the block itself (model to CDF_INIT, pends to 0).
// The Pallas kernel's one-hot bf16 matmuls for the row fetch and the
// histogram, and its f32-reciprocal division, are not carried over: the
// integer unit divides.
//
// What bounds it.  Per step ~250 integer operations (six row-entry
// loads, three averages at one entry, five exact divisions of ~25
// instructions each, the adjustment, up to eight atomics) and per touched
// row a commit of ~100 (16 entries, a division, the renorm passes); 40 B
// of trace in and 8 B out a step, so operations bound it on paper.  The
// chain that bounds a block is the chunk loop: two barriers a chunk, and
// each phase waits on L2 latency (dependent loads, atomics); one block
// per lane, so a batch of B lanes fills B SMs.  Many lanes per launch,
// a packed trace, or staging a chunk's rows in shared memory are later
// work; the output does not depend on how lanes map to blocks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 10;
constexpr int kMaxChunk = 1024;
constexpr int kMaxThreads = 256;
constexpr int kAdjClamp = 1 << 21;
constexpr int kWeightMax = (1 << 30) - 1;
constexpr int kMaxRenorm = 24;
constexpr int kSlabInts = 52;      // a row's ints in the lane's slab

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

// The mixer weight rules of one "which": clip, 24-bit over-rule,
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
  uint32_t u = (uint32_t)v;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) u += __shfl_down_sync(0xffffffffu, u, o);
  return (int)u;
}

// One hit into a parity's pend; the row's first hit of the chunk lists it.
__device__ __forceinline__ void record(int row, int sym, int inc, int lim,
                                       int* add, int* limsum, int* hits,
                                       int* touched, int* n_touched) {
  atomicAdd(add + (size_t)row * 16 + sym, inc);
  atomicAdd(limsum + row, lim);
  if (atomicAdd(hits + row, 1) == 0) touched[atomicAdd(n_touched, 1)] = row;
}

// Commit one touched row from its pend, then clear the pend.
__device__ __forceinline__ void commit_row(int* model_row, int* add_row,
                                           int* limsum, int* hits) {
  int v[16];
  int cum = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    cum = add32(cum, add_row[i]);
    v[i] = add32(model_row[i], cum);
    add_row[i] = 0;
  }
  const int lim_eff = floor_div(*limsum, max(*hits, 1));
  *limsum = 0;
  *hits = 0;
  for (int p = 0; p < kMaxRenorm && v[15] >= lim_eff; ++p) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int cb = add32(v[i], i + 1);
      v[i] = cb - (cb >> 2);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) model_row[i] = v[i];
}

__global__ void __launch_bounds__(kMaxThreads)
deferred_pass_kernel(const int32_t* __restrict__ trace, int n,
                     const int32_t* __restrict__ counts,
                     int32_t* __restrict__ scratch,
                     int32_t* __restrict__ starts,
                     int32_t* __restrict__ freqs, int num_rows, int s) {
  __shared__ int touched[2][2 * kMaxChunk];   // rows a chunk touched
  __shared__ int n_touched[3];                // per chunk, slot c % 3
  __shared__ int wadj[2][4];                  // [parity][which][cm, nib]
  __shared__ int weights[6];                  // [which][w0, w1, nw]

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t r = (size_t)num_rows;
  int32_t* model = scratch + (size_t)lane * kSlabInts * r;   // [R][16]
  int32_t* add = model + 16 * r;                             // [2][R][16]
  int32_t* limsum = add + 32 * r;                            // [2][R]
  int32_t* hits = limsum + 2 * r;                            // [2][R]
  // a count past the row (or below 0) is clamped: the lane's outputs
  // stay inside its row whatever the caller passes
  const int n_steps = min(max(counts[lane], 0), n);
  const int n_chunks = (n_steps + s - 1) / s;
  const int32_t* tr = trace + (size_t)lane * n * kCols;
  int32_t* st_out = starts + (size_t)lane * n;
  int32_t* fr_out = freqs + (size_t)lane * n;

  for (size_t i = tid; i < 16 * r; i += blockDim.x) {
    model[i] = 4 * ((int)(i & 15) + 1);   // CDF_INIT
  }
  for (size_t i = tid; i < 36 * r; i += blockDim.x) add[i] = 0;
  if (tid < 3) n_touched[tid] = 0;
  if (tid < 8) wadj[tid >> 2][tid & 3] = 0;
  if (tid < 2) {
    weights[3 * tid] = 1;
    weights[3 * tid + 1] = 1;
    weights[3 * tid + 2] = 1 << 14;
  }
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int par = c & 1;
    int* add_new = add + par * 16 * r;
    int* limsum_new = limsum + par * r;
    int* hits_new = hits + par * r;
    // ---- phase A: code chunk c's steps against the frozen snapshot
    int adj[4] = {0, 0, 0, 0};           // [which][cm, nib]
    for (int j = tid; j < s; j += blockDim.x) {
      const int t = c * s + j;
      if (t >= n_steps) {
        st_out[t] = 0;
        fr_out[t] = 0;
        continue;
      }
      const int32_t* x = tr + (size_t)t * kCols;
      const int flat = x[0], sym = x[1], inc = x[3], lim = x[4];
      const bool mix = x[5] != 0;
      const int which = x[6], cm_idx = x[7], cm_inc = x[8], cm_lim = x[9];
      const int ip = sym > 0 ? sym - 1 : 0;
      const int* nr = model + (size_t)flat * 16;
      const int n_prev = nr[ip], n_sym = nr[sym], n_max = nr[15];
      int start, freq;
      if (!mix) {
        start_freq(n_prev, n_sym, n_max, sym, start, freq);
      } else {
        const int* cr = model + (size_t)cm_idx * 16;
        const int c_prev = cr[ip], c_sym = cr[sym], c_max = cr[15];
        const int rate = weights[3 * which + 2] & 0xFFFF;
        int p_cm, p_nib, unused;
        start_freq(c_prev, c_sym, c_max, sym, unused, p_cm);
        start_freq(n_prev, n_sym, n_max, sym, unused, p_nib);
        const int shift = max(bitlen(mul32(c_max, n_max)) - 15, 0);
        const int m_prev = average_at(c_prev, n_prev, shift, c_max, n_max,
                                      rate);
        const int m_sym = average_at(c_sym, n_sym, shift, c_max, n_max,
                                     rate);
        const int m_max = average_at(c_max, n_max, shift, c_max, n_max,
                                     rate);
        start_freq(m_prev, m_sym, m_max, sym, start, freq);
        const int error = (1 << 15) - freq;
        const int sh = max(bitlen(mul32(freq, error)) - 15, 0);
        const int a_cm = min(max(mul32(error, p_cm - freq) >> sh,
                                 -kAdjClamp), kAdjClamp);
        const int a_nib = min(max(mul32(error, p_nib - freq) >> sh,
                                  -kAdjClamp), kAdjClamp);
        if (which == 0) {
          adj[0] = add32(adj[0], a_cm);
          adj[1] = add32(adj[1], a_nib);
        } else {
          adj[2] = add32(adj[2], a_cm);
          adj[3] = add32(adj[3], a_nib);
        }
      }
      st_out[t] = start;
      fr_out[t] = freq;
      if (inc != 0) {
        record(flat, sym, inc, lim, add_new, limsum_new, hits_new,
               touched[par], &n_touched[c % 3]);
      }
      if (mix && cm_inc != 0) {
        record(cm_idx, sym, cm_inc, cm_lim, add_new, limsum_new, hits_new,
               touched[par], &n_touched[c % 3]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = warp_sum(adj[k]);
      if ((tid & 31) == 0) atomicAdd(&wadj[par][k], v);
    }
    __syncthreads();

    // ---- phase B: commit chunk c-1's touched rows and weights
    if (c > 0) {
      const int pp = par ^ 1;
      const int nt = n_touched[(c + 2) % 3];   // chunk c-1's slot
      int* add_old = add + pp * 16 * r;
      int* limsum_old = limsum + pp * r;
      int* hits_old = hits + pp * r;
      for (int j = tid; j < nt; j += blockDim.x) {
        const int row = touched[pp][j];
        commit_row(model + (size_t)row * 16, add_old + (size_t)row * 16,
                   limsum_old + row, hits_old + row);
      }
      if (tid == 0) {
        commit_weights(weights, wadj[pp]);
        commit_weights(weights + 3, wadj[pp] + 2);
        for (int k = 0; k < 4; ++k) wadj[pp][k] = 0;
      }
    }
    if (tid == 0) n_touched[(c + 1) % 3] = 0;  // chunk c+1's slot
    __syncthreads();
  }
  // steps past the lane's last chunk
  for (int i = n_chunks * s + tid; i < n; i += blockDim.x) {
    st_out[i] = 0;
    fr_out[i] = 0;
  }
}

}  // namespace

// trace int32[B, n, 10], counts int32[B], scratch int32[B, 52 * num_rows]
// (any contents: each block sets up its lane's slab) -> starts, freqs
// int32[B, n].  One block per lane of min(max(s, 32), 256) threads; s a
// power of two in [16, 1024] dividing n.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int dtpu_deferred_pass(const void* trace, int n,
                                  const void* counts, void* scratch,
                                  void* starts, void* freqs, int B,
                                  int num_rows, int s, void* stream) {
  const int threads = s < 32 ? 32 : (s > kMaxThreads ? kMaxThreads : s);
  deferred_pass_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)trace, n, (const int32_t*)counts, (int32_t*)scratch,
      (int32_t*)starts, (int32_t*)freqs, num_rows, s);
  return (int)cudaGetLastError();
}
