// Adaptive-profile (per-nibble) model pass of the encode, for Hopper
// (sm_90a).
//
// Replaces the reference's device program divans_tpu/codec/jax_engine.py:77
// (`model_pass`, an XLA lax.scan, no Pallas kernel) together with the host
// split of its output by stream (:1031-1040).  Contract, per frame (one
// metablock's 10-column trace, codec/trace.py's column order, against a
// fresh model of R rows of CDF_INIT and weights (1, 1, 2^14) for each
// mixer): step k, in order and without lag, reads its nibble row `flat`
// and its cm row `cm_idx`; when `mix` is set it codes against
// cdf16.average(cm row, nibble row, weights[which][2] & 0xFFFF), else
// against the nibble row; it emits (start, freq) of `value`; on a mixing
// step the weights of `which` take weights.update with the value's freq
// under the cm row, the nibble row and the coded row; then the nibble row
// is written blended by (inc, lim) and the cm row blended by (cm_inc,
// cm_lim), both from the rows read before the step, in that order (where
// the two rows coincide the cm blend stays).  A step of stream 0 (cmd) or
// 1 (lit) writes its (start, freq) at the running count of its stream's
// lane, 2b or 2b + 1 of [2B, n_lane]; a padding step (stream -1) writes
// nothing.  The counts go to counts[2b], counts[2b + 1]; a lane's columns
// past n_lane are not written (the wrapper sizes n_lane from the trace).
// The arithmetic is csrc/adaptive.cuh's, exactly the reference's int32.
//
// Design: row chains, then a weight chain.  Every symbol is known in
// advance (the trace's `value`), so a model row evolves by its own blend
// events alone; the only serial state across rows is the two mixers'
// weights.  Two launches:
//   1. rows_kernel, a block of 512 threads a frame, in two phases.
//      Row chains: each step contributes two blend events in step order,
//      its nibble row's (inc, lim) and its cm row's (cm_inc, cm_lim), both
//      on the pre-step rows (one, the cm blend, where the rows coincide).
//      The block stages the trace a tile of 512 steps at a time in shared
//      memory (the next tile's rows in flight in registers meanwhile);
//      each row belongs to one of 32 half-warps by a hash of its index,
//      and each warp scans the tile's events by ballot, its two halves
//      running their own rows' events in step order side by side, a row a
//      half, an entry a lane (csrc/adaptive_warp.cuh), the row last used
//      kept in registers.  A chain records, for each step, the pre-step
//      entries the step's coding reads (v - 1, v and 15 of the nibble row,
//      and on a mixing step of the cm row: 12 B a step, in a global
//      scratch).  An inc-0 event that neither changes its row (entry 15
//      below its lim) nor is read is skipped with its neighbours in one
//      ballot, so the no-op event each non-mixing step sends to the
//      frozen row 0 costs no chain step.
//      Steps in parallel: a thread a step, a tile at a time, computes the
//      step's output position (a block-wide prefix count of its stream
//      and of its mixer), then a non-mixing step's (start, freq), written
//      to its lane, or a mixing step's weight-free inputs: its two freqs
//      under the cm and nibble rows and the three averaged entries as
//      lines in the rate (one multiply-add each), written to its mixer's
//      list.  Two blocks fit an SM, so 192 frames start together.
//   2. weights_kernel, a warp a mixer a frame: the weight chain.  Each
//      mixing step is rate -> three averages -> (start, freq) (two
//      divisions by the mixed max, whose reciprocal a table in shared
//      memory holds) -> weights.update (norm_weight's 8-bit division a
//      256-entry table), the (start, freq) written to its lane; the list
//      is read 32 steps a load a tile ahead, the next step's inputs
//      shuffled in before this one's chain.
// The model lives in shared memory where R x 32 B fits beside the tile
// (cm 2,379 rows, 76,128 B; stride 4,572, 146,304 B), else in a global
// scratch slab of R x 32 B per frame (mix, 22,859 rows).
//
// What bounds it.  Per step 40 B of trace in and 8 B out, and ~230
// integer operations (~170 more on a mixing step); operations bound it
// on paper.  The real limit is the weight chain, one mixing step after
// another in one warp (~150 instructions, ~45 of them dependent), then
// the longest row chain; a launch takes as long as its longest frame, so
// the frames of a call go in one launch each.
#include <cstdint>
#include <cuda_runtime.h>

#include "adaptive.cuh"
#include "adaptive_warp.cuh"

namespace {

using adaptive::kFullMask;

constexpr int kCols = 10;
constexpr int kThreads = 512;            // rows_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;          // steps a tile
constexpr int kTileEvents = 2 * kTile;
constexpr size_t kTileBytes = kTileEvents * sizeof(int4);

// a staged event: x = row | v << 16 | read-as-nibble-row << 20 |
// read-as-cm-row << 21 | owner << 22 | valid << 27, y = inc, z = lim,
// w = the step's index in its frame
constexpr int kValid = 1 << 27;

__device__ __forceinline__ int owner_of(int row) {
  return (int)(((uint32_t)row * 0x9E3779B1u) >> 27);   // 32 half-warps
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A trace row of a tile in flight, as the two events it stages.
struct StepEvents {
  int4 nib, cm;
};

__device__ __forceinline__ StepEvents stage(const int* t, int k, int n) {
  StepEvents e;
  if (k >= n) {
    e.nib = e.cm = make_int4(0, 0, 0, 0);
    return e;
  }
  const int* x = t + (size_t)k * kCols;
  const int flat = x[0], value = x[1], stream = x[2], inc = x[3];
  const int lim = x[4], mix = x[5], cm_idx = x[7], cm_inc = x[8];
  const int cm_lim = x[9];
  const int coded = (mix != 0 || stream == 0 || stream == 1) ? 1 : 0;
  const int rd_cm = mix != 0 ? 1 : 0;
  if (flat == cm_idx) {
    // one row: the cm blend is the one kept; it records both reads
    e.nib = make_int4(0, 0, 0, 0);
    e.cm = make_int4(cm_idx | value << 16 | coded << 20 | rd_cm << 21
                         | owner_of(cm_idx) << 22 | kValid,
                     cm_inc, cm_lim, k);
  } else {
    e.nib = make_int4(flat | value << 16 | coded << 20
                          | owner_of(flat) << 22 | kValid,
                      inc, lim, k);
    e.cm = make_int4(cm_idx | value << 16 | rd_cm << 21
                         | owner_of(cm_idx) << 22 | kValid,
                     cm_inc, cm_lim, k);
  }
  return e;
}

// One half-warp's row chain: the row last used, this lane's entry of it
// and its entry 15, in registers.
struct Chain {
  int row = -1, c = 0, c15 = 0;
};

__device__ __forceinline__ void record(int16_t* rec, int v, int ent, int c) {
  if (ent == v - 1) rec[0] = (int16_t)c;
  if (ent == v) rec[1] = (int16_t)c;
  if (ent == 15) rec[2] = (int16_t)c;
}

// The row chains' pass over one staged tile: warp w runs the events of
// half-warps 2w and 2w + 1, each half its own in step order.
__device__ __forceinline__ void chains_tile(const int4* tile, int16_t* model,
                                            int16_t* rec, Chain& ch) {
  const int lane = threadIdx.x & 31, ent = lane & 15, half = lane >> 4;
  const int warp = threadIdx.x >> 5;
  for (int c = 0; c < kTileEvents / 32; ++c) {
    const int4 ev = tile[c * 32 + lane];
    const int owner = (ev.x >> 22) & 31;
    const bool mine = (ev.x & kValid) != 0 && (owner >> 1) == warp;
    const unsigned all = __ballot_sync(kFullMask, mine);
    if (all == 0) continue;
    const unsigned upper = __ballot_sync(kFullMask, mine && (owner & 1));
    unsigned m0 = all & ~upper, m1 = upper;
    const int e_half = owner & 1, e_row = ev.x & 0x7FFF;
    // an event that may be a no-op: inc 0 and no step reads it
    const bool quiet = mine && ev.y == 0 && ((ev.x >> 20) & 3) == 0;
    const bool any_quiet = __any_sync(kFullMask, quiet);
    while ((m0 | m1) != 0) {
      // skip, in each half, the quiet events before its first event that
      // can change a row: entry 15 below lim, read from the half's
      // registers for the row it holds, else from the model
      unsigned n0 = m0, n1 = m1;
      if (any_quiet) {
        const int o_row = __shfl_xor_sync(kFullMask, ch.row, 16);
        const int o_c15 = __shfl_xor_sync(kFullMask, ch.c15, 16);
        const int h_row = e_half == half ? ch.row : o_row;
        const int h_c15 = e_half == half ? ch.c15 : o_c15;
        bool skip = false;
        if (quiet) {
          const int top = e_row == h_row ? h_c15
                                         : model[(size_t)e_row * 16 + 15];
          skip = top < ev.z;
        }
        const unsigned s = __ballot_sync(kFullMask, skip);
        n0 = m0 & ~s;
        n1 = m1 & ~s;
      }
      const int f0 = n0 != 0 ? __ffs(n0) - 1 : -1;
      const int f1 = n1 != 0 ? __ffs(n1) - 1 : -1;
      m0 = n0 != 0 ? m0 & ~((2u << f0) - 1u) : 0u;
      m1 = n1 != 0 ? m1 & ~((2u << f1) - 1u) : 0u;
      const int f = half ? f1 : f0;
      // the half's event, one broadcast read of the tile
      const int4 e = tile[c * 32 + (f >= 0 ? f : 0)];
      const int x = e.x, inc = e.y, lim = e.z, k = e.w;
      const int row = x & 0x7FFF;
      const bool switched = f >= 0 && row != ch.row;
      if (switched) {
        if (ch.row >= 0) adaptive::store_entry(model, ch.row, ch.c);
        ch.c = adaptive::load_entry(model, row);
        ch.c15 = model[(size_t)row * 16 + 15];
        ch.row = row;
      }
      if (f >= 0) {
        const int v = (x >> 16) & 15;
        int16_t* r = rec + (size_t)k * 6;
        if ((x >> 20) & 1) record(r, v, ent, ch.c);
        if ((x >> 21) & 1) record(r + 3, v, ent, ch.c);
        ch.c = adaptive::lane_blend(ch.c, ent, ch.c15, v, inc, lim);
        ch.c15 = adaptive::blend_top(ch.c15, inc, lim);
      }
      __syncwarp();
    }
  }
}

// rows_kernel's arguments (frame b's trace at rows offsets[b] .., its
// outputs, the work space)
struct RowsArgs {
  const int* trace;
  const long long* offsets;
  const int* n_steps;
  int num_rows, n_lane;
  int* starts;
  int* freqs;
  int* counts;
  int16_t* scratch;
  int16_t* recs;
  int4* elem_a;
  int4* elem_b;
  int* elem_info;
  int* mix_counts;
  const uint32_t* div_table;
  long long* phase_ns;
};

// kSlab: the model in the global scratch slab, else in shared memory.  Two
// blocks an SM (64 registers a thread), so that a launch's frames (192
// over 48 MiB) start together on the 132 SMs.
template <bool kSlab>
__global__ void __launch_bounds__(kThreads, 2) rows_kernel(const RowsArgs a) {
  const int* __restrict__ trace = a.trace;
  const int num_rows = a.num_rows, n_lane = a.n_lane;
  int* __restrict__ starts = a.starts;
  int* __restrict__ freqs = a.freqs;
  int16_t* __restrict__ scratch = a.scratch;
  const uint32_t* __restrict__ div_table = a.div_table;
  extern __shared__ int4 smem[];
  __shared__ int wsum[kWarps][4];
  const long long t_start = global_ns();
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int16_t* model = kSlab ? scratch + (size_t)b * num_rows * 16
                         : reinterpret_cast<int16_t*>(smem);
  adaptive::fill_model(model, num_rows);
  int4* tile = kSlab ? smem : smem + 2 * num_rows;
  const int n = a.n_steps[b];
  const long long off = a.offsets[b];
  const int* t = trace + off * kCols;
  int16_t* rec = a.recs + off * 6;

  // ---- phase 1: the row chains over the staged tiles
  Chain ch;
  StepEvents next = stage(t, threadIdx.x, n);
  for (int base = 0; base < n; base += kTile) {
    __syncthreads();   // the model is filled; the last tile is done
    tile[2 * threadIdx.x] = next.nib;
    tile[2 * threadIdx.x + 1] = next.cm;
    __syncthreads();
    next = stage(t, base + kTile + threadIdx.x, n);
    chains_tile(tile, model, rec, ch);
  }
  __syncthreads();   // every record written
  const long long t_rows = global_ns();

  // ---- phase 2: every step's position, then its (start, freq) or its
  // mixer's inputs
  int carry[4] = {0, 0, 0, 0};   // stream 0, stream 1, mixer 0, mixer 1
  for (int base = 0; base < n; base += kTile) {
    const int k = base + threadIdx.x;
    const bool live = k < n;
    int value = 0, stream = -1, mix = 0, which = 0;
    if (live) {
      const int* x = t + (size_t)k * kCols;
      value = x[1];
      stream = x[2];
      mix = x[5];
      which = x[6];
    }
    const bool flag[4] = {stream == 0, stream == 1,
                          live && mix != 0 && which == 0,
                          live && mix != 0 && which == 1};
    int pre[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned bq = __ballot_sync(kFullMask, flag[q]);
      pre[q] = __popc(bq & lanemask_lt());
      if (lane == 0) wsum[warp][q] = __popc(bq);
    }
    __syncthreads();
    int pos[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int before = 0, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? wsum[w][q] : 0;
        total += wsum[w][q];
      }
      pos[q] = carry[q] + before + pre[q];
      carry[q] += total;
    }
    __syncthreads();   // wsum read before the next tile writes it
    if (!live) continue;
    // the step's record: the nibble row's entries v - 1, v, 15, then the
    // cm row's
    const int* rw = reinterpret_cast<const int*>(rec + (size_t)k * 6);
    const int w0 = rw[0], w1 = rw[1], w2 = rw[2];
    const int nv1 = (int)(int16_t)(w0 & 0xFFFF), nv = w0 >> 16;
    const int n15 = (int)(int16_t)(w1 & 0xFFFF), cv1 = w1 >> 16;
    const int cv = (int)(int16_t)(w2 & 0xFFFF), c15 = w2 >> 16;
    if (mix == 0) {
      if (stream != 0 && stream != 1) continue;
      const adaptive::Recip rn = adaptive::recip_of(n15, div_table);
      int start, freq;
      adaptive::start_freq_of(adaptive::scaled(nv1, rn),
                              adaptive::scaled(nv, rn), value, &start, &freq);
      const int p = pos[stream];
      if (p < n_lane) {
        const size_t o = (size_t)(2 * b + stream) * n_lane + p;
        starts[o] = start;
        freqs[o] = freq;
      }
      continue;
    }
    // a mixing step: its freqs under the cm and nibble rows, and the
    // three averaged entries as lines in the rate (from their sides
    // (a * bmax) >> shift and (b * amax) >> shift, a the cm row's entry, b
    // the nibble row's)
    const adaptive::Recip rc = adaptive::recip_of(c15, div_table);
    const adaptive::Recip rn = adaptive::recip_of(n15, div_table);
    int st_cm, p_cm, st_nib, p_nib;
    adaptive::start_freq_of(adaptive::scaled(cv1, rc),
                            adaptive::scaled(cv, rc), value, &st_cm, &p_cm);
    adaptive::start_freq_of(adaptive::scaled(nv1, rn),
                            adaptive::scaled(nv, rn), value, &st_nib,
                            &p_nib);
    const int sh = adaptive::mix_shift(c15, n15);
    const int a1 = value > 0 ? cv1 : 0, b1 = value > 0 ? nv1 : 0;
    const int e = which == 0 ? (int)off + pos[2]
                             : (int)off + n - 1 - pos[3];
    const int max_sides = (c15 * n15) >> sh;   // the same either side
    a.elem_a[e] = make_int4(
        adaptive::mix_slope((a1 * n15) >> sh, (b1 * c15) >> sh),
        adaptive::mix_base((b1 * c15) >> sh),
        adaptive::mix_slope((cv * n15) >> sh, (nv * c15) >> sh),
        adaptive::mix_base((nv * c15) >> sh));
    a.elem_b[e] = make_int4(adaptive::mix_slope(max_sides, max_sides),
                            adaptive::mix_base(max_sides), p_cm, p_nib);
    const int p = stream == 0 || stream == 1 ? pos[stream] : 0;
    a.elem_info[e] = value | (stream + 1) << 4 | p << 8;
  }
  const long long t_steps = global_ns();
  if (threadIdx.x == 0) {
    a.counts[2 * b] = carry[0];
    a.counts[2 * b + 1] = carry[1];
    a.mix_counts[2 * b] = carry[2];
    a.mix_counts[2 * b + 1] = carry[3];
    if (a.phase_ns != nullptr) {
      a.phase_ns[3 * b] = t_rows - t_start;
      a.phase_ns[3 * b + 1] = t_steps - t_rows;
    }
  }
}

// A mixing step's weight-free inputs, as the weight chain reads them.
struct MixStep {
  int slope0, base0, slope1, base1, slope2, base2, p_cm, p_nib, info;
};

__device__ __forceinline__ MixStep shfl_step(const int4& a, const int4& b,
                                             int info, int src) {
  MixStep m;
  m.slope0 = __shfl_sync(kFullMask, a.x, src);
  m.base0 = __shfl_sync(kFullMask, a.y, src);
  m.slope1 = __shfl_sync(kFullMask, a.z, src);
  m.base1 = __shfl_sync(kFullMask, a.w, src);
  m.slope2 = __shfl_sync(kFullMask, b.x, src);
  m.base2 = __shfl_sync(kFullMask, b.y, src);
  m.p_cm = __shfl_sync(kFullMask, b.z, src);
  m.p_nib = __shfl_sync(kFullMask, b.w, src);
  m.info = __shfl_sync(kFullMask, info, src);
  return m;
}

__global__ void __launch_bounds__(64) weights_kernel(
    const long long* __restrict__ offsets, const int* __restrict__ n_steps,
    int n_lane, int* __restrict__ starts, int* __restrict__ freqs,
    const int4* __restrict__ elem_a, const int4* __restrict__ elem_b,
    const int* __restrict__ elem_info, const int* __restrict__ mix_counts,
    const uint32_t* __restrict__ div_table, long long* __restrict__ phase_ns) {
  extern __shared__ uint32_t hot[];   // the divisors' hot range
  __shared__ int inv_table[256];
  const long long t_start = global_ns();
  adaptive::init_inv_table(inv_table);
  adaptive::load_hot(hot, div_table);
  __syncthreads();
  const int b = blockIdx.x, which = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int count = mix_counts[2 * b + which];
  const long long off = offsets[b];
  const int n = n_steps[b];
  // mixer 0's list runs up from the frame's first slot, mixer 1's down
  // from its last
  const int first = which == 0 ? (int)off : (int)off + n - 1;
  const int dir = which == 0 ? 1 : -1;
  int w0 = 1, w1 = 1, w2 = adaptive::kNormWeightInit;
  int4 na = make_int4(0, 0, 0, 0), nb = na;
  int ninfo = 0;
  if (lane < count) {
    const int e = first + dir * lane;
    na = elem_a[e];
    nb = elem_b[e];
    ninfo = elem_info[e];
  }
  for (int base = 0; base < count; base += 32) {
    const int4 ca = na, cb = nb;
    const int cinfo = ninfo;
    if (base + 32 + lane < count) {
      // the next 32 steps' inputs, in flight during these 32
      const int e = first + dir * (base + 32 + lane);
      na = elem_a[e];
      nb = elem_b[e];
      ninfo = elem_info[e];
    }
    const int m = count - base < 32 ? count - base : 32;
    MixStep nx = shfl_step(ca, cb, cinfo, 0);
    for (int u = 0; u < m; ++u) {
      const MixStep s = nx;
      nx = shfl_step(ca, cb, cinfo, u + 1 < m ? u + 1 : u);
      const int rate = w2 & 0xFFFF;
      const int value = s.info & 15;
      const int c_prev = adaptive::average_linear(s.slope0, s.base0, rate);
      const int c_sym = adaptive::average_linear(s.slope1, s.base1, rate);
      const int maxv = adaptive::average_linear(s.slope2, s.base2, rate);
      const adaptive::Recip rm = adaptive::recip_of(maxv, div_table, hot);
      int start, freq;
      adaptive::start_freq_of(adaptive::scaled(c_prev, rm),
                              adaptive::scaled(c_sym, rm), value, &start,
                              &freq);
      const int stream = ((s.info >> 4) & 3) - 1;
      const int p = s.info >> 8;
      if (lane == u && stream >= 0 && p < n_lane) {
        const size_t o = (size_t)(2 * b + stream) * n_lane + p;
        starts[o] = start;
        freqs[o] = freq;
      }
      adaptive::update_weights(w0, w1, w2, s.p_cm, s.p_nib, freq, inv_table);
    }
  }
  if (phase_ns != nullptr && lane == 0) {
    const long long t = global_ns() - t_start;
    atomicMax(reinterpret_cast<unsigned long long*>(phase_ns + 3 * b + 2),
              (unsigned long long)t);
  }
}

}  // namespace

// The largest model kept in shared memory, in bytes; a larger one takes
// the global scratch slab.
extern "C" int dtpu_model_pass_max_shared() { return adaptive::kMaxShared; }

// trace int32 [T, 10] (frame b's steps at rows offsets[b] ..
// offsets[b] + n_steps[b]), offsets int64 [B], n_steps int32 [B] ->
// starts, freqs int32 [2B, n_lane], counts int32 [2B].  scratch: int16
// [B, num_rows, 16] when num_rows x 32 B exceeds the shared limit, else
// null.  Work space: recs int16 [T, 6], elem_a, elem_b int32 [T, 4],
// elem_info int32 [T], mix_counts int32 [2B].  div_table: uint32
// [32769], the reciprocals of adaptive.cuh's Recip.  phase_ns:
// null, or int64
// [B, 3] (zeroed) for each frame's row chains, steps and weight chains in
// ns.  Two launches on `stream`; returns cudaGetLastError() after them.
extern "C" int dtpu_model_pass(const void* trace, const void* offsets,
                               const void* n_steps, int b, int num_rows,
                               int n_lane, void* starts, void* freqs,
                               void* counts, void* scratch, void* recs,
                               void* elem_a, void* elem_b, void* elem_info,
                               void* mix_counts, const void* div_table,
                               void* phase_ns, void* stream) {
  const bool slab = scratch != nullptr;
  size_t smem;
  const cudaError_t e = slab
      ? adaptive::model_smem(rows_kernel<true>, num_rows, true, kTileBytes,
                             &smem)
      : adaptive::model_smem(rows_kernel<false>, num_rows, false, kTileBytes,
                             &smem);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  const RowsArgs a{static_cast<const int*>(trace),
                   static_cast<const long long*>(offsets),
                   static_cast<const int*>(n_steps), num_rows, n_lane,
                   static_cast<int*>(starts), static_cast<int*>(freqs),
                   static_cast<int*>(counts), static_cast<int16_t*>(scratch),
                   static_cast<int16_t*>(recs), static_cast<int4*>(elem_a),
                   static_cast<int4*>(elem_b), static_cast<int*>(elem_info),
                   static_cast<int*>(mix_counts),
                   static_cast<const uint32_t*>(div_table),
                   static_cast<long long*>(phase_ns)};
  if (slab) {
    rows_kernel<true><<<b, kThreads, smem, s>>>(a);
  } else {
    rows_kernel<false><<<b, kThreads, smem, s>>>(a);
  }
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  const cudaError_t e2 = cudaFuncSetAttribute(
      weights_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)adaptive::kHotBytes);
  if (e2 != cudaSuccess) return (int)e2;
  weights_kernel<<<b, 64, adaptive::kHotBytes, s>>>(
      static_cast<const long long*>(offsets),
      static_cast<const int*>(n_steps), n_lane, static_cast<int*>(starts),
      static_cast<int*>(freqs), static_cast<const int4*>(elem_a),
      static_cast<const int4*>(elem_b), static_cast<const int*>(elem_info),
      static_cast<const int*>(mix_counts),
      static_cast<const uint32_t*>(div_table),
      static_cast<long long*>(phase_ns));
  return (int)cudaGetLastError();
}
