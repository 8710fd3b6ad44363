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
// 227 KB.  So each lane's model lives in global memory (`scratch`, 16
// ints a row: 1.3 MB a lane in the mix profile, 21 MB for 16 lanes, which
// stays in the 50 MB L2), and everything else stays on chip.  One block
// of 256 threads per lane loops over the lane's chunks; thread j takes
// steps j, j + 256, ... of each chunk.  A chunk has three phases:
//   A. Thread 0 starts the bulk copy (TMA, completing on an mbarrier) of
//      the next chunk's trace into the other staging buffer, and the
//      block starts copying (cp.async, 4 threads a row) the model rows
//      chunk c-1 touched, the snapshot through c-2 that their commit adds
//      to, into the fold area.  Each step, its trace read from the
//      staging buffer, reads the entries it needs (sym-1, sym, 15 of the
//      row and of the cm row) from the frozen snapshot in global memory
//      and writes (start, freq): one L2 round trip serves the steps and
//      the commit, and the warp's hash inserts run while it is in
//      flight.  A hit is a record (key, inc, lim) at the step's own
//      place (2j for the row, 2j+1 for the cm row) in the records of
//      parity c & 1; its key is the row's slot in a shared open-
//      addressing hash of the chunk's rows (atomicCAS).  The insert that
//      claims a slot lists the row on the parity's touched list, at a
//      place taken by one shared atomic for all of a warp's claims.  The
//      four adjustment sums are warp-shuffle reductions and shared
//      atomics.
//   B1. Each record of chunk c trades its slot for its row's place on the
//      touched list; chunk c-1's records fold into the fold area: per
//      touched row its 16 inc sums by symbol, its lim sum and its hits
//      (shared atomics, integer and order-free).
//   B2. The hash is cleared; a thread a row commits chunk c-1's touched
//      rows from shared memory (the cumulative inc sums, lim_eff, the
//      renorm passes) back into the fold area, and each warp stores its
//      rows, 4 threads a row, so that a 16-byte store instruction covers
//      8 whole rows (a thread a row would scatter it over 32); thread 0
//      commits the weights.
// A barrier ends each phase.  No global atomic is left, and global memory
// holds only the model.  Rows no hit touched are never committed, the
// normative rule.  The floor divisions run on the FP64 unit, exact (see
// floor_div.cuh).  The block sets up its lane's model (CDF_INIT, 16-byte
// stores).
//
// Shared memory, sized by s (a chunk touches at most 2s rows):
//   staged trace  2 parities x s steps x 10 ints       80 s B
//   records       2 parities x 2s x (key, inc, lim)    48 s B
//   touched lists 2 parities x 2s rows                 16 s B
//   hash          4s row ids + 4s u16 list places      24 s B
//   fold area     K rows x (the model row and the 16 inc sums, each in a
//                 row of 20 ints, so that a thread's 16-byte accesses to
//                 its row meet no bank conflict; lim sum, hits) 168 K B
// K = min(2s, the rows that fit in what is left of 232,448 B less 256 B
// for the static words, a multiple of 16).  Through s = 256 every
// touched row fits (K = 2s); at s = 512 K = 864 and at s = 1024 K = 352,
// so a chunk that touched more rows copies, folds and commits them in
// rounds of K, the same code.  s = 256: 129,024 B; s = 512 and 1024:
// 231,168 B.
//
// What bounds it.  Per step ~250 integer operations (six row-entry
// loads, three averages at one entry, six floor divisions, the
// adjustment, the hash inserts) and per touched row a commit of ~100
// (the fold's atomics, 16 entries, a division, the renorm passes); 40 B
// of trace in and 8 B out a step, so operations bound it on paper.  The
// chain that bounds a block is the chunk loop: three barriers, one L2
// round trip and the memory instructions of 256 steps that each touch
// their own rows a chunk.  One block per lane, so a batch of B lanes
// fills B SMs; the output does not depend on how lanes map to blocks.
#include <cstdint>
#include <cuda_runtime.h>

#include "floor_div.cuh"

namespace {

constexpr int kCols = 10;
constexpr int kThreads = 256;
constexpr int kAdjClamp = 1 << 21;
constexpr int kWeightMax = (1 << 30) - 1;
constexpr int kMaxRenorm = 24;
constexpr int kSmemMax = 232448;   // a block's shared memory on sm_90
constexpr int kStaticBytes = 256;  // reserved for the static shared words
constexpr int kFoldStride = 20;    // ints a fold row's 16 entries take
constexpr int kFoldRowBytes = 8 * kFoldStride + 8;
constexpr unsigned kFull = 0xffffffffu;

// Rows of the fold area, and the dynamic shared memory, at chunk s.
__host__ __device__ constexpr int fold_rows(int s) {
  const int fit = ((kSmemMax - kStaticBytes - 168 * s) / kFoldRowBytes) & ~15;
  return fit < 2 * s ? fit : 2 * s;
}

__host__ __device__ constexpr int smem_bytes(int s) {
  return 168 * s + kFoldRowBytes * fold_rows(s);
}

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
  for (int o = 16; o > 0; o >>= 1) u += __shfl_down_sync(kFull, u, o);
  return (int)u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}

// Thread 0 copies `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory in one TMA bulk copy; `bar` completes its
// phase when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The block starts copying the model rows list[r0, r1) into the fold
// area, 4 threads a row (16 B each), so that a warp's copies cover 8
// whole rows.
__device__ __forceinline__ void load_rows(int* f_model, const int32_t* model,
                                          const int* list, int r0, int r1) {
  for (int q = threadIdx.x; q < 4 * (r1 - r0); q += kThreads) {
    const int at = q >> 2, part = 4 * (q & 3);
    cp_async16(f_model + at * kFoldStride + part,
               model + (size_t)list[r0 + at] * 16 + part);
  }
}

// A row's slot in the chunk's hash, for every lane of the warp (row -1:
// no hit, slot -1).  The insert whose atomicCAS claims a slot lists the
// row, at a place taken by one atomic for all the warp's claims.
__device__ __forceinline__ int insert(int row, int* hkey, uint16_t* hval,
                                      int hbits, int* touched,
                                      int* n_touched) {
  const int lane = threadIdx.x & 31;
  int slot = -1;
  bool claimed = false;
  if (row >= 0) {
    const int mask = (1 << hbits) - 1;
    slot = (int)(((uint32_t)row * 0x9E3779B1u) >> (32 - hbits));
    while (true) {
      const int k = atomicCAS(hkey + slot, -1, row);
      if (k == -1 || k == row) {
        claimed = k == -1;
        break;
      }
      slot = (slot + 1) & mask;
    }
  }
  const unsigned cl = __ballot_sync(kFull, claimed);
  if (cl != 0) {
    const int first = __ffs(cl) - 1;
    int base = 0;
    if (lane == first) base = atomicAdd(n_touched, __popc(cl));
    base = __shfl_sync(kFull, base, first);
    if (claimed) {
      const int place = base + __popc(cl & ((1u << lane) - 1u));
      touched[place] = row;
      hval[slot] = (uint16_t)place;
    }
  }
  return slot;
}

// Chunk c-1's records whose row's place lies in [r0, r1) into the fold
// area: per row its 16 inc sums by symbol, its lim sum and its hits.
__device__ __forceinline__ void fold(const int* rec, int s, int r0, int r1,
                                     int* f_add, int* f_lim, int* f_hits) {
  const int* key = rec;
  const int* inc = rec + 2 * s;
  const int* lim = inc + 2 * s;
  for (int i = threadIdx.x; i < 2 * s; i += kThreads) {
    const int k = key[i];
    if (k < 0) continue;
    const int at = (k & 0xFFFF) - r0;
    if (at < 0 || at >= r1 - r0) continue;
    atomicAdd(f_add + at * kFoldStride + (k >> 16), inc[i]);
    atomicAdd(f_lim + at, lim[i]);
    atomicAdd(f_hits + at, 1);
  }
}

// Commit the rows list[r0, r1) from the fold area, a thread a row; the
// committed rows go back into the fold area's model rows and from there
// to global memory, 4 threads a row (a warp's 16-byte stores cover 8
// whole rows, where a thread a row would scatter them over 32); the inc
// sums, lim sums and hits are cleared.
__device__ __forceinline__ void commit_rows(int32_t* model, const int* list,
                                            int r0, int r1, int* f_model,
                                            int* f_add, int* f_lim,
                                            int* f_hits) {
  const int4 zero = make_int4(0, 0, 0, 0);
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < r1 - r0; base += kThreads) {   // block-uniform
    const int at = base + threadIdx.x;
    if (at < r1 - r0) {
      int4* fm = reinterpret_cast<int4*>(f_model + at * kFoldStride);
      int4* fa = reinterpret_cast<int4*>(f_add + at * kFoldStride);
      const int lim_eff = floor_div(f_lim[at], max(f_hits[at], 1));
      int v[16], a[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 m = fm[q], d = fa[q];
        v[4 * q] = m.x, v[4 * q + 1] = m.y, v[4 * q + 2] = m.z,
        v[4 * q + 3] = m.w;
        a[4 * q] = d.x, a[4 * q + 1] = d.y, a[4 * q + 2] = d.z,
        a[4 * q + 3] = d.w;
        fa[q] = zero;
      }
      f_lim[at] = 0;
      f_hits[at] = 0;
      int cum = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        cum = add32(cum, a[i]);
        v[i] = add32(v[i], cum);
      }
      for (int p = 0; p < kMaxRenorm && v[15] >= lim_eff; ++p) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int cb = add32(v[i], i + 1);
          v[i] = cb - (cb >> 2);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fm[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
    }
    __syncwarp();   // the warp's 32 rows are in the fold area
    const int first = base + (threadIdx.x & ~31);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int at_k = first + 8 * k + (lane >> 2), part = 4 * (lane & 3);
      if (at_k < r1 - r0) {
        *reinterpret_cast<int4*>(model + (size_t)list[r0 + at_k] * 16 + part) =
            *reinterpret_cast<const int4*>(f_model + at_k * kFoldStride + part);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
deferred_pass_kernel(const int32_t* __restrict__ trace, int n,
                     const int32_t* __restrict__ counts,
                     int32_t* __restrict__ scratch,
                     int32_t* __restrict__ starts,
                     int32_t* __restrict__ freqs, int num_rows, int s) {
  extern __shared__ __align__(16) int smem[];
  const int fk = fold_rows(s);
  int* stage = smem;                       // [2][s][10]
  int* f_model = stage + 2 * s * kCols;    // [K][20]
  int* f_add = f_model + kFoldStride * fk; // [K][20]
  int* f_lim = f_add + kFoldStride * fk;   // [K]
  int* f_hits = f_lim + fk;                // [K]
  int* rec = f_hits + fk;                  // [2][key, inc, lim][2s]
  int* touched = rec + 12 * s;             // [2][2s]
  int* hkey = touched + 4 * s;             // [4s]
  uint16_t* hval = (uint16_t*)(hkey + 4 * s);   // [4s]
  __shared__ __align__(8) uint64_t staged[2];   // the stage's mbarriers
  __shared__ int n_touched[2];             // per parity
  __shared__ int wadj[2][4];               // [parity][which][cm, nib]
  __shared__ int weights[6];               // [which][w0, w1, nw]

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int hbits = 33 - __clz(s);         // log2(4s)
  const size_t r = (size_t)num_rows;
  int32_t* model = scratch + (size_t)lane * 16 * r;   // [R][16]
  // a count past the row (or below 0) is clamped: the lane's outputs
  // stay inside its row whatever the caller passes
  const int n_steps = min(max(counts[lane], 0), n);
  const int n_chunks = (n_steps + s - 1) / s;
  const int32_t* tr = trace + (size_t)lane * n * kCols;
  int32_t* st_out = starts + (size_t)lane * n;
  int32_t* fr_out = freqs + (size_t)lane * n;
  const uint32_t chunk_bytes = (uint32_t)s * kCols * 4;

  int4* model4 = reinterpret_cast<int4*>(model);
  for (size_t q = tid; q < 4 * r; q += kThreads) {
    const int e = 4 * (int)(q & 3);        // CDF_INIT: 4 (e + 1)
    model4[q] = make_int4(4 * e + 4, 4 * e + 8, 4 * e + 12, 4 * e + 16);
  }
  for (int i = tid; i < kFoldStride * fk; i += kThreads) f_add[i] = 0;
  for (int i = tid; i < fk; i += kThreads) {
    f_lim[i] = 0;
    f_hits[i] = 0;
  }
  for (int i = tid; i < 4 * s; i += kThreads) hkey[i] = -1;
  if (tid < 2) n_touched[tid] = 0;
  if (tid < 8) wadj[tid >> 2][tid & 3] = 0;
  if (tid < 2) {
    weights[3 * tid] = 1;
    weights[3 * tid + 1] = 1;
    weights[3 * tid + 2] = 1 << 14;
  }
  if (tid == 0) {
    mbar_init(&staged[0]);
    mbar_init(&staged[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_chunks > 0) bulk_load(stage, tr, chunk_bytes, &staged[0]);
  }
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int par = c & 1, pp = par ^ 1;
    const int nt_old = c > 0 ? n_touched[pp] : 0;   // chunk c-1's rows
    const int* list_old = touched + pp * 2 * s;
    int* key = rec + par * 6 * s;
    int* rinc = key + 2 * s;
    int* rlim = rinc + 2 * s;
    // ---- phase A: code chunk c's steps against the frozen snapshot
    if (tid == 0 && c + 1 < n_chunks) {
      bulk_load(stage + pp * s * kCols, tr + (size_t)(c + 1) * s * kCols,
                chunk_bytes, &staged[pp]);
    }
    load_rows(f_model, model, list_old, 0, min(nt_old, fk));
    mbar_wait(&staged[par], (c >> 1) & 1);  // chunk c's trace is in
    const int* x_chunk = stage + par * s * kCols;
    int adj[4] = {0, 0, 0, 0};              // [which][cm, nib]
    for (int j0 = 0; j0 < s; j0 += kThreads) {
      if (j0 + (tid & ~31) >= s) break;     // warp-uniform
      const int j = j0 + tid;
      const int t = c * s + j;
      const bool live = j < s && t < n_steps;
      // the trace, and the rows' entries from the snapshot: their loads
      // are in flight while the warp inserts the rows into the hash
      int row = -1, cm_row = -1;
      int sym = 0, inc = 0, lim = 0, cm_inc = 0, cm_lim = 0, which = 0;
      bool mix = false;
      int n_prev = 0, n_sym = 0, n_max = 0, c_prev = 0, c_sym = 0, c_max = 0;
      if (live) {
        const int* x = x_chunk + j * kCols;
        const int flat = x[0], cm_idx = x[7];
        sym = x[1];
        inc = x[3];
        lim = x[4];
        mix = x[5] != 0;
        which = x[6];
        cm_inc = x[8];
        cm_lim = x[9];
        const int ip = sym > 0 ? sym - 1 : 0;
        const int* nr = model + (size_t)flat * 16;
        n_prev = nr[ip];
        n_sym = nr[sym];
        n_max = nr[15];
        if (mix) {
          const int* cr = model + (size_t)cm_idx * 16;
          c_prev = cr[ip];
          c_sym = cr[sym];
          c_max = cr[15];
          if (cm_inc != 0) cm_row = cm_idx;
        }
        if (inc != 0) row = flat;
      } else if (j < s && t < n) {
        st_out[t] = 0;
        fr_out[t] = 0;
      }
      int* list = touched + par * 2 * s;
      const int k0 = insert(row, hkey, hval, hbits, list, &n_touched[par]);
      const int k1 = insert(cm_row, hkey, hval, hbits, list,
                            &n_touched[par]);
      if (live) {
        int start, freq;
        if (!mix) {
          start_freq(n_prev, n_sym, n_max, sym, start, freq);
        } else {
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
      }
      if (j < s) {
        key[2 * j] = row >= 0 ? k0 | (sym << 16) : -1;
        key[2 * j + 1] = cm_row >= 0 ? k1 | (sym << 16) : -1;
        rinc[2 * j] = inc;
        rlim[2 * j] = lim;
        rinc[2 * j + 1] = cm_inc;
        rlim[2 * j + 1] = cm_lim;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = warp_sum(adj[k]);
      if ((tid & 31) == 0) atomicAdd(&wadj[par][k], v);
    }
    cp_async_wait_all();                    // this thread's model rows
    __syncthreads();

    // ---- phase B1: slots to list places; fold chunk c-1's records
    for (int i = tid; i < 2 * s; i += kThreads) {
      const int k = key[i];
      if (k >= 0) key[i] = (k & ~0xFFFF) | hval[k & 0xFFFF];
    }
    const int* rec_old = rec + pp * 6 * s;
    if (nt_old > 0) fold(rec_old, s, 0, min(nt_old, fk), f_add, f_lim, f_hits);
    __syncthreads();

    // ---- phase B2: commit chunk c-1's touched rows and weights
    for (int i = tid; i < 4 * s; i += kThreads) hkey[i] = -1;
    for (int r0 = 0; r0 < nt_old; r0 += fk) {   // block-uniform
      const int r1 = min(nt_old, r0 + fk);
      if (r0 > 0) {                         // a later round (s >= 512)
        __syncthreads();
        load_rows(f_model, model, list_old, r0, r1);
        cp_async_wait_all();
        __syncthreads();
        fold(rec_old, s, r0, r1, f_add, f_lim, f_hits);
        __syncthreads();
      }
      commit_rows(model, list_old, r0, r1, f_model, f_add, f_lim, f_hits);
    }
    if (tid == 0) {
      if (c > 0) {
        commit_weights(weights, wadj[pp]);
        commit_weights(weights + 3, wadj[pp] + 2);
      }
      for (int k = 0; k < 4; ++k) wadj[pp][k] = 0;
      n_touched[pp] = 0;                    // chunk c+1's list
    }
    __syncthreads();
  }
  // steps past the lane's last chunk
  for (int i = n_chunks * s + tid; i < n; i += kThreads) {
    st_out[i] = 0;
    fr_out[i] = 0;
  }
}

}  // namespace

// The dynamic shared memory a launch at chunk s takes (bytes).
extern "C" int dtpu_deferred_pass_smem(int s) { return smem_bytes(s); }

// trace int32[B, n, 10], counts int32[B], scratch int32[B, 16 * num_rows]
// (any contents: each block sets up its lane's model) -> starts, freqs
// int32[B, n].  One block of 256 threads per lane, smem_bytes(s) of
// dynamic shared memory; s a power of two in [16, 1024] dividing n.
// Launches on `stream` and returns cudaGetLastError() (or the error of
// the shared-memory attribute).
extern "C" int dtpu_deferred_pass(const void* trace, int n,
                                  const void* counts, void* scratch,
                                  void* starts, void* freqs, int B,
                                  int num_rows, int s, void* stream) {
  const int smem = smem_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(
      deferred_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  deferred_pass_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)trace, n, (const int32_t*)counts, (int32_t*)scratch,
      (int32_t*)starts, (int32_t*)freqs, num_rows, s);
  return (int)cudaGetLastError();
}
