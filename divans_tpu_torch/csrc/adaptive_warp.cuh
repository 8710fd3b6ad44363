// Warp-wide row operations of the adaptive profile, shared by the decode
// scan (scan_decode.cu) and the model pass's row chains (model_pass.cu):
// a row's 16 entries live one a lane, on lanes 0-15 or 16-31 of a warp
// (a half), so a row operation is a few instructions of every lane
// instead of a 16-entry loop in one thread.  Every lane of the warp
// calls each function (the shuffles and ballots name all 32 lanes); the
// two halves may hold two rows.  The arithmetic is adaptive.cuh's.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "adaptive.cuh"

namespace adaptive {

constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// this lane's entry (lane & 15) of row `row`
__device__ __forceinline__ int load_entry(const int16_t* model, int row) {
  return model[(size_t)row * 16 + (threadIdx.x & 15)];
}

__device__ __forceinline__ void store_entry(int16_t* model, int row, int c) {
  model[(size_t)row * 16 + (threadIdx.x & 15)] = (int16_t)c;
}

// cdf16.offset_to_sym of the row on lanes 0-15: the count of lanes i < 15
// whose entry c is at most (offset * max) >> 15, by one ballot
__device__ __forceinline__ int ballot_sym(int c, int maxv, int offset) {
  const int resc = (offset * maxv) >> kLog2Scale;
  return __popc(__ballot_sync(kFullMask, c <= resc) & 0x7FFFu);
}

// (start, freq) of symbol sym from each lane's quotient r =
// scaled(c, max) of the row on lanes base .. base + 15: two shuffles
__device__ __forceinline__ void lane_start_freq(int r, int sym, int base,
                                                int* start, int* freq) {
  const int r_sym = __shfl_sync(kFullMask, r, base + sym);
  const int r_prev = __shfl_sync(kFullMask, r, base + (sym > 0 ? sym - 1 : 0));
  start_freq_of(r_prev, r_sym, sym, start, freq);
}

// cdf16.blend of this lane's entry c (entry i of its row): bump the
// entries >= sym by inc; renorm when entry 15 after the bump is >= lim.
// c15 is the row's entry 15 before the bump (every lane of the half
// holds it), so no lane waits on lane 15.
__device__ __forceinline__ int lane_blend(int c, int i, int c15, int sym,
                                          int inc, int lim) {
  const int bumped = wrap16((uint32_t)c + (i >= sym ? (uint32_t)inc : 0u));
  const int top = wrap16((uint32_t)c15 + (uint32_t)inc);
  const int cb = wrap16((uint32_t)bumped + (uint32_t)(i + 1));
  const int renormed = wrap16((uint32_t)cb - (uint32_t)(cb >> 2));
  return top >= lim ? renormed : bumped;
}

// entry 15 after lane_blend, from entry 15 before it (any lane)
__device__ __forceinline__ int blend_top(int c15, int inc, int lim) {
  const int top = wrap16((uint32_t)c15 + (uint32_t)inc);
  const int cb = wrap16((uint32_t)top + 16u);
  return top >= lim ? wrap16((uint32_t)cb - (uint32_t)(cb >> 2)) : top;
}

// A stream's u16 words as a register tile of the warp: lane l holds word
// base + l (`cur`) and base + 32 + l (`nxt`, loaded a tile ahead), each
// read at its index modulo W (W a power of two, so a corrupt stream
// wraps exactly as the reference's pos % W).  word(pos) needs pos - base
// in [0, 32): the reader's position moves one word at a time and calls
// advance after each.
struct WordTile {
  const int* words;
  int mask, base, cur, nxt;

  __device__ __forceinline__ void init(const int* w, int width) {
    words = w;
    mask = width - 1;
    base = 0;
    cur = words[lane_id() & mask];
    nxt = words[(32 + lane_id()) & mask];
  }

  __device__ __forceinline__ int word(int pos) const {
    return __shfl_sync(kFullMask, cur, pos - base);
  }

  __device__ __forceinline__ void advance(int pos) {
    if (pos - base == 32) {
      base += 32;
      cur = nxt;
      nxt = words[(base + 32 + lane_id()) & mask];
    }
  }
};

}  // namespace adaptive
