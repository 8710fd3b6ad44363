// Wide rANS (rans32) reverse encode, one lane per thread, for Hopper
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
// Design.  One thread per lane walks its symbols backward with the
// state in a register; the layout is the port's natural [B, N], lanes
// first, so a warp's loads are strided by N (each thread streams its own
// row backward; a cache line serves 32 consecutive steps of one lane).
// The TPU kernel's f32-reciprocal division was a Mosaic workaround;
// here it is an integer division.
//
// What bounds it.  The serial chain per symbol: compare, shift, one
// integer division (a ~25-instruction sequence) and the update, ~40
// dependent instructions a symbol, for every lane at once; on paper the
// bytes (8 B in, 3 B out a symbol) bound it, far below the chain.  With
// one batch's lanes (tens) in flight the card runs tens of threads: a
// symbol-major layout, lanes from several batches per launch, or
// interleaved states per lane are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;

// floor(a / b) for b >= 1 (the reference's `//`).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b) != 0 && a < 0) --q;
  return q;
}

__global__ void __launch_bounds__(kBlock) rans_encode_kernel(
    const int32_t* __restrict__ starts, const int32_t* __restrict__ freqs,
    const int32_t* __restrict__ counts, int16_t* __restrict__ words,
    int8_t* __restrict__ flags, int32_t* __restrict__ states, int B, int N) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= B) return;
  const int32_t* st = starts + (size_t)l * N;
  const int32_t* fr = freqs + (size_t)l * N;
  int16_t* wo = words + (size_t)l * N;
  int8_t* fo = flags + (size_t)l * N;
  const int count = counts[l];
  int32_t state = 1 << 15;
  for (int t = N - 1; t >= 0; --t) {
    wo[t] = (int16_t)(state & 0xFFFF);
    if (t >= count) {
      fo[t] = 0;
      continue;
    }
    const int freq = max(__ldg(fr + t), 1);
    const bool flag = state >= (int32_t)((uint32_t)freq << 16);
    fo[t] = flag ? 1 : 0;
    if (flag) state >>= 16;
    const int q = floor_div(state, freq);
    state = (int32_t)(((uint32_t)q << 15) + (uint32_t)(state - q * freq) +
                      (uint32_t)__ldg(st + t));
  }
  states[l] = state;
}

}  // namespace

// starts, freqs int32[B, N], counts int32[B] -> words int16[B, N],
// flags int8[B, N], states int32[B].  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dtpu_rans_encode(const void* starts, const void* freqs,
                                const void* counts, void* words, void* flags,
                                void* states, int B, int N, void* stream) {
  const dim3 grid((B + kBlock - 1) / kBlock);
  rans_encode_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)starts, (const int32_t*)freqs, (const int32_t*)counts,
      (int16_t*)words, (int8_t*)flags, (int32_t*)states, B, N);
  return (int)cudaGetLastError();
}
