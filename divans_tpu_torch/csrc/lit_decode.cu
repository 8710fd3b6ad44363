// Deferred-profile literal decode, one chunk per launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel divans_tpu/codec/pallas_decode.py:182
// (_make_lit_kernel, launched by _chunk_call at :295).  Same contract:
// every lane decodes up to s bytes of its literal stream against a model
// that is frozen for the chunk and arrives premixed (192 int16 CDF
// planes per lane: 64 hi planes indexed by ctx, then 128 lo planes
// indexed by (ctx >> 3) * 16 + hi).  Per byte:
//   sel = lut0[p1] | lut1[p2];  ctx = lcmap[sel]
//   hi  = nibble(plane ctx);    lo = nibble(plane 64 + (ctx>>3)*16 + hi)
// and per nibble (rans32, divans_tpu/ans/coder_np.py):
//   if state < 2^15: state = state << 16 | next u16 word
//   slot = state & 0x7FFF; sym = #{i < 15 : cdf[i] <= (slot*max) >> 15}
//   start/freq from floor(cdf << 15 / max); state = freq*(state>>15)+slot-start
// Lanes with t >= n_rem write byte 0 and ctx 0 and leave their scalars.
//
// Design.  One thread per lane, looping over the chunk's bytes.  The TPU
// kernel's select-scan plane fetch, 6-bit packed tables, staged word
// window and f32-reciprocal division were Mosaic workarounds; here a
// lane reads its plane with two 16-byte loads, its renorm word straight
// from its packed word row (index clamped to W-1, so corrupt input cannot
// read out of bounds) and divides with integer division.
//
// What bounds it.  Each lane is one dependent chain (plane gather ->
// symbol search -> division -> state -> next gather), so the kernel is
// latency-bound: its bytes (the 786 KB of premixed planes for 128
// lanes, L2-resident, plus a few KB of words) take well under a
// microsecond at HBM rate.  32-thread blocks spread the lanes over
// several SMs, so each SM's L1 holds its lanes' planes.  Widening the
// lanes per launch (more independent chains) and fusing the commit are
// later work; the output bytes do not depend on the lane count.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanes = 192;   // premixed planes per lane
constexpr int kHi = 64;        // hi planes come first
constexpr int kBlock = 32;

// floor(a / b) for b >= 1 (torch's integer `//`).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b) != 0 && a < 0) --q;
  return q;
}

// Decode one nibble from the premixed plane at `plane`; int32 wrap
// semantics throughout (as the int32 tensors of the plain version).
__device__ __forceinline__ int decode_nibble(
    const int16_t* __restrict__ plane, int32_t& state, int& pulls,
    const int32_t* __restrict__ wrow, int W, int cursor) {
  const int h = cursor + pulls;
  const int32_t packed = __ldg(wrow + min(h >> 1, W - 1));
  const uint32_t word = ((uint32_t)packed >> ((h & 1) * 16)) & 0xFFFFu;
  if (state < 32768) {
    state = (int32_t)(((uint32_t)state << 16) | word);
    ++pulls;
  }
  const int4* p4 = reinterpret_cast<const int4*>(plane);
  const int4 a = __ldg(p4);
  const int4 b = __ldg(p4 + 1);
  const int32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int cdf[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cdf[2 * i] = (int16_t)(v[i] & 0xFFFF);
    cdf[2 * i + 1] = (int16_t)((uint32_t)v[i] >> 16);
  }
  const int slot = state & 0x7FFF;
  const int resc = (slot * cdf[15]) >> 15;
  int sym = 0;
#pragma unroll
  for (int i = 0; i < 15; ++i) sym += (cdf[i] <= resc);
  int c_sym = 0, c_prev = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i == sym) c_sym = cdf[i];
    if (i + 1 == sym) c_prev = cdf[i];
  }
  const int m = max(cdf[15], 1);
  const int r_sym = floor_div(c_sym * 32768, m);
  const int r_prev = sym > 0 ? floor_div(c_prev * 32768, m) : 0;
  const int start = r_prev + 1;
  const int freq = r_sym - r_prev - 1;
  state = (int32_t)((uint32_t)freq * (uint32_t)(state >> 15) +
                    (uint32_t)slot - (uint32_t)start);
  return sym;
}

__global__ void __launch_bounds__(kBlock) lit_decode_chunk_kernel(
    const int16_t* __restrict__ model, const int32_t* __restrict__ words,
    int W, const int32_t* __restrict__ lcmap,
    const int32_t* __restrict__ luts, const int32_t* __restrict__ sc_in,
    uint8_t* __restrict__ bytes_out, uint8_t* __restrict__ ctx_out,
    int32_t* __restrict__ sc_out, int B, int s) {
  __shared__ int lut[512];
  for (int i = threadIdx.x; i < 512; i += blockDim.x) lut[i] = luts[i];
  __syncthreads();
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= B) return;
  int32_t state = sc_in[l];
  int p1 = sc_in[B + l];
  int p2 = sc_in[2 * B + l];
  const int n_rem = sc_in[3 * B + l];
  const int cursor = sc_in[4 * B + l];
  int pulls = 0;
  const int16_t* m = model + (size_t)l * kPlanes * 16;
  const int32_t* wrow = words + (size_t)l * W;
  const int32_t* lc = lcmap + (size_t)l * 64;
  uint8_t* bo = bytes_out + (size_t)l * s;
  uint8_t* co = ctx_out + (size_t)l * s;
  const int n_act = max(0, min(s, n_rem));
  for (int t = 0; t < n_act; ++t) {
    const int sel = lut[p1 & 255] | lut[256 + (p2 & 255)];
    const int ctx = __ldg(lc + (sel & 63)) & 63;
    const int hi = decode_nibble(m + ctx * 16, state, pulls, wrow, W, cursor);
    const int lo = decode_nibble(m + (kHi + (ctx >> 3) * 16 + hi) * 16,
                                 state, pulls, wrow, W, cursor);
    const int byte = (hi << 4) | lo;
    bo[t] = (uint8_t)byte;
    co[t] = (uint8_t)ctx;
    p2 = p1;
    p1 = byte;
  }
  for (int t = n_act; t < s; ++t) {
    bo[t] = 0;
    co[t] = 0;
  }
  sc_out[l] = state;
  sc_out[B + l] = p1;
  sc_out[2 * B + l] = p2;
  sc_out[3 * B + l] = pulls;
}

}  // namespace

// model int16[B,192,16], words int32[B,W], lcmap int32[B,64],
// luts int32[512] (lut0 ++ lut1), sc_in int32[5,B] (state, p1, p2, n_rem,
// halfword cursor) -> bytes_out uint8[B,s], ctx_out uint8[B,s],
// sc_out int32[4,B] (state, p1, p2, pulls).  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int dtpu_lit_decode_chunk(const void* model, const void* words,
                                     int W, const void* lcmap,
                                     const void* luts, const void* sc_in,
                                     void* bytes_out, void* ctx_out,
                                     void* sc_out, int B, int s,
                                     void* stream) {
  const dim3 grid((B + kBlock - 1) / kBlock);
  lit_decode_chunk_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const int16_t*)model, (const int32_t*)words, W,
      (const int32_t*)lcmap, (const int32_t*)luts, (const int32_t*)sc_in,
      (uint8_t*)bytes_out, (uint8_t*)ctx_out, (int32_t*)sc_out, B, s);
  return (int)cudaGetLastError();
}
