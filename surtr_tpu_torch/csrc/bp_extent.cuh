// The valid extent of a broadphase pool, shared by the key launches of
// kernels B6 (broadphase_exact.cu) and B12 (broadphase_sorted.cu).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace surtr_bp {

constexpr float EXT_BIG = 3.4e38f;
constexpr unsigned EXT_FULL = 0xffffffffu;

__device__ inline float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(EXT_FULL, v, o));
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(EXT_FULL, v, o));
  return v;
}

// One CTA (blockDim.x a multiple of 32, at most 1024) reduces, per axis,
// amin(where(valid, c, BIG)) and amax(where(valid, c, -BIG)) over the rows
// first, first + step, ... of its threads (thread t starts at
// first + t; row stride cs), as the plain versions' torch.amin / amax do
// for finite centers: no valid row gives BIG and -BIG. Every thread
// returns with mn and mx; the result says whether any of the rows is
// valid. It holds barriers, so every thread of the CTA calls it. Minimum
// and maximum do not depend on the order (PTX orders -0 below +0), so any
// split of the rows reduces to the same bits.
__device__ inline bool valid_extent_rows(const float* __restrict__ c, int cs,
                                         const unsigned char* __restrict__ valid, int Np,
                                         int first, int step, float mn[3], float mx[3]) {
  __shared__ float red[32][6];
  __shared__ float out[6];
  const int t = threadIdx.x;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mn[a] = INFINITY;
    mx[a] = -INFINITY;
  }
  int any = 0;
  for (int i = first + t; i < Np; i += step) {
    const bool v = valid[i] != 0;
    any |= v;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float x = c[(size_t)i * cs + a];
      mn[a] = fminf(mn[a], v ? x : EXT_BIG);
      mx[a] = fmaxf(mx[a], v ? x : -EXT_BIG);
    }
  }
  any = __syncthreads_or(any);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mn[a] = warp_min(mn[a]);
    mx[a] = warp_max(mx[a]);
  }
  if ((t & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      red[t >> 5][a] = mn[a];
      red[t >> 5][3 + a] = mx[a];
    }
  }
  __syncthreads();
  if (t < 32) {
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mn[a] = warp_min(t < nw ? red[t][a] : INFINITY);
      mx[a] = warp_max(t < nw ? red[t][3 + a] : -INFINITY);
    }
    if (t == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        out[a] = mn[a];
        out[3 + a] = mx[a];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mn[a] = out[a];
    mx[a] = out[3 + a];
  }
  return any != 0;
}

// The whole pool's extent in one CTA.
__device__ inline bool valid_extent(const float* __restrict__ c, int cs,
                                    const unsigned char* __restrict__ valid, int Np, float mn[3],
                                    float mx[3]) {
  return valid_extent_rows(c, cs, valid, Np, 0, blockDim.x, mn, mx);
}

}  // namespace surtr_bp
