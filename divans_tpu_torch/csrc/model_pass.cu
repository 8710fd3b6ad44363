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
// Design.  One block per frame: the 32 threads fill the model with
// CDF_INIT, then thread 0 runs the frame's serial chain (each step reads
// the rows the step before it wrote, so a frame has no parallelism but
// its 16 entries, left for a later design).  The model lives in shared
// memory where R x 32 B fits a block (cm 2,379 rows, 76,128 B; stride
// 4,572, 146,304 B), else in a global scratch slab of R x 32 B per frame
// (mix, 22,859 rows).  The trace row of the next step is loaded while
// the current one is coded; a mixing step averages only the three
// entries its (start, freq) reads; each floor division goes through
// csrc/floor_div.cuh's FP64 sequence, one reciprocal a row max.
//
// What bounds it.  Per step 40 B of trace in and 8 B out, and ~250
// integer operations (~450 on a mixing step: three averaged entries, six
// divisions, the mixer update); operations bound it on paper.  The real
// limit is the serial chain of a frame, ~300-600 dependent cycles a step
// in one thread; a launch takes as long as its longest frame, so the
// frames of a call go in one launch (192 at 2^18 over 48 MiB).
#include <cstdint>
#include <cuda_runtime.h>

#include "adaptive.cuh"

namespace {

constexpr int kCols = 10;
constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads) model_pass_kernel(
    const int* __restrict__ trace, const long long* __restrict__ offsets,
    const int* __restrict__ n_steps, int num_rows, int n_lane,
    int* __restrict__ starts, int* __restrict__ freqs,
    int* __restrict__ counts, int16_t* __restrict__ scratch) {
  extern __shared__ int4 smem[];
  __shared__ int weights[2][3];
  const int b = blockIdx.x;
  int16_t* model = adaptive::init_model(smem, scratch, b, num_rows);
  adaptive::init_weights(weights);
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int n = n_steps[b];
  const int* t = trace + offsets[b] * kCols;
  int* lane_st[2] = {starts + (size_t)(2 * b) * n_lane,
                     starts + (size_t)(2 * b + 1) * n_lane};
  int* lane_fr[2] = {freqs + (size_t)(2 * b) * n_lane,
                     freqs + (size_t)(2 * b + 1) * n_lane};
  int cnt[2] = {0, 0};
  int x[kCols];
  if (n > 0) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) x[j] = t[j];
  }
  for (int k = 0; k < n; ++k) {
    // the next step's trace row, in flight while this one is coded
    int nx[kCols];
    const int* tn = t + (size_t)(k + 1 < n ? k + 1 : k) * kCols;
#pragma unroll
    for (int j = 0; j < kCols; ++j) nx[j] = tn[j];
    const int flat = x[0], value = x[1], stream = x[2], inc = x[3];
    const int lim = x[4], mix = x[5], which = x[6], cm_idx = x[7];
    const int cm_inc = x[8], cm_lim = x[9];
    int row[16], cmr[16];
    adaptive::load_row(model, flat, row);
    adaptive::load_row(model, cm_idx, cmr);
    int start, freq;
    if (mix != 0) {
      int* w = weights[which];
      const adaptive::Mix m = adaptive::mix_of(cmr[15], row[15],
                                               w[2] & 0xFFFF);
      const int c_sym = adaptive::average(m, adaptive::pick(cmr, value),
                                          adaptive::pick(row, value));
      const int c_prev = adaptive::average(
          m, adaptive::pick(cmr, value - 1), adaptive::pick(row, value - 1));
      const int maxv = adaptive::average(m, cmr[15], row[15]);
      adaptive::start_freq(c_prev, c_sym, maxv, value, &start, &freq);
      adaptive::update_weights(w, adaptive::freq_of(cmr, value),
                               adaptive::freq_of(row, value), freq);
    } else {
      adaptive::start_freq(adaptive::pick(row, value - 1),
                           adaptive::pick(row, value), row[15], value,
                           &start, &freq);
    }
    adaptive::blend(row, value, inc, lim);
    adaptive::store_row(model, flat, row);
    adaptive::blend(cmr, value, cm_inc, cm_lim);
    adaptive::store_row(model, cm_idx, cmr);
    if (stream == 0 || stream == 1) {
      const int c = cnt[stream];
      if (c < n_lane) {
        lane_st[stream][c] = start;
        lane_fr[stream][c] = freq;
      }
      cnt[stream] = c + 1;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) x[j] = nx[j];
  }
  counts[2 * b] = cnt[0];
  counts[2 * b + 1] = cnt[1];
}

}  // namespace

// The largest model kept in shared memory, in bytes; a larger one takes
// the global scratch slab.
extern "C" int dtpu_model_pass_max_shared() { return adaptive::kMaxShared; }

// trace int32 [T, 10] (frame b's steps at rows offsets[b] ..
// offsets[b] + n_steps[b]), offsets int64 [B], n_steps int32 [B] ->
// starts, freqs int32 [2B, n_lane], counts int32 [2B].  scratch: int16
// [B, num_rows, 16] when num_rows x 32 B exceeds the shared limit, else
// null.  Returns cudaGetLastError() after the launch.
extern "C" int dtpu_model_pass(const void* trace, const void* offsets,
                               const void* n_steps, int b, int num_rows,
                               int n_lane, void* starts, void* freqs,
                               void* counts, void* scratch, void* stream) {
  size_t smem;
  const cudaError_t e = adaptive::model_smem(model_pass_kernel, num_rows,
                                             scratch != nullptr, &smem);
  if (e != cudaSuccess) return (int)e;
  model_pass_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(trace), static_cast<const long long*>(offsets),
      static_cast<const int*>(n_steps), num_rows, n_lane,
      static_cast<int*>(starts), static_cast<int*>(freqs),
      static_cast<int*>(counts), static_cast<int16_t*>(scratch));
  return (int)cudaGetLastError();
}
