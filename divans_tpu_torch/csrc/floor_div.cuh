// Exact floor division on the FP64 unit, shared by the model passes
// (cmd_pass.cu, deferred_pass.cu, lit_pass.cu).
#pragma once

// floor(a / b) for b >= 1 (torch's integer `//`), given rcp = 1.0 / b in
// double: |a| < 2^31, so a * rcp is within 2^-21 / b of a / b, less than
// the 1 / b that separates a / b from the next integer, and one
// correction by the remainder (an exact quotient may land just below)
// makes it exact.  nvcc makes this ~12 instructions for sm_90a (convert
// a, multiply, convert back with floor, the remainder's wide multiply-add,
// two compares and the correction) and the reciprocal ~10 (a MUFU seed
// and five FMAs on the FP64 unit), once a divisor; the integer unit's
// division takes ~25.
__device__ __forceinline__ int floor_div(int a, int b, double rcp) {
  int q = (int)floor((double)a * rcp);
  const long long r = (long long)a - (long long)q * b;
  if (r >= b) {
    ++q;
  } else if (r < 0) {
    --q;
  }
  return q;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return floor_div(a, b, 1.0 / (double)b);
}
