// Batched refit planes: tetra hull + zero-gap k-DOP slabs (kernel B4).
//
// Replaces: surtr_tpu/ops/refit_pallas.py `_refit_kernel` (wrapper
// `refit_planes_batch_pallas`). Semantics of the plain version in
// surtr_tpu_torch/ops/refit_cuda.py (tetra_hull + kdop_planes(gap=0)): per
// candidate the four greedy first-of-ties extreme points (max x, farthest
// from it, max triangle area, max tetra volume), the tetra's four face
// normals oriented outward against its centroid (|n| <= 1e-20 invalid),
// and for each normal the slab [max plane (n, -max n.v); min plane
// (-n, min n.v)] over the masked pool. Output order [4 max; 4 min]; the
// mask also needs >= 4 valid points.
//
// What bounds it on the card: reading the pool (N x Pv x 3 floats, 7.3 MB
// at N = 1088, Pv = 608) eight times over (4 argmax + 4 support passes)
// from L2, plus warp reduction latency. Design: one warp per candidate
// (four per block); every pass is a strided sweep of the candidate's pool
// by the 32 lanes followed by a shuffle reduction, first-of-ties on
// (value, index) like jnp.argmax; nothing is staged in shared memory
// because each pass touches the pool once and the pool fits in L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -3.4e38f;
constexpr int WARPS = 4;

__device__ __forceinline__ void argmax_reduce(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ float max_reduce(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float min_reduce(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename Score>
__device__ int warp_argmax(const float* pool, const unsigned char* m, int Pv,
                           Score score) {
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int j = threadIdx.x & 31; j < Pv; j += 32) {
    const float s = m[j] ? score(pool + j * 3) : NEG;
    if (s > bv || (s == bv && j < bi)) { bv = s; bi = j; }
  }
  argmax_reduce(bv, bi);
  return bi;
}

__global__ void refit_kernel(const float* __restrict__ pool_all,
                             const unsigned char* __restrict__ mask_all,
                             float* __restrict__ planes_out,
                             unsigned char* __restrict__ pmask_out, int N,
                             int Pv) {
  const int cand = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (cand >= N) return;  // whole warp exits together
  const int lane = threadIdx.x & 31;
  const float* pool = pool_all + (size_t)cand * Pv * 3;
  const unsigned char* m = mask_all + (size_t)cand * Pv;

  int cnt = 0;
  for (int j = lane; j < Pv; j += 32) cnt += m[j] != 0;
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);

  float p[4][3];
  const int i1 = warp_argmax(pool, m, Pv, [](const float* v) { return v[0]; });
  for (int a = 0; a < 3; ++a) p[0][a] = pool[i1 * 3 + a];
  const int i2 = warp_argmax(pool, m, Pv, [&](const float* v) {
    const float dx = v[0] - p[0][0], dy = v[1] - p[0][1], dz = v[2] - p[0][2];
    return (dx * dx + dy * dy) + dz * dz;
  });
  for (int a = 0; a < 3; ++a) p[1][a] = pool[i2 * 3 + a];
  const float ex = p[1][0] - p[0][0], ey = p[1][1] - p[0][1], ez = p[1][2] - p[0][2];
  const int i3 = warp_argmax(pool, m, Pv, [&](const float* v) {
    const float rx = v[0] - p[0][0], ry = v[1] - p[0][1], rz = v[2] - p[0][2];
    const float cx = ey * rz - ez * ry, cy = ez * rx - ex * rz, cz = ex * ry - ey * rx;
    return (cx * cx + cy * cy) + cz * cz;
  });
  for (int a = 0; a < 3; ++a) p[2][a] = pool[i3 * 3 + a];
  const int i4 = warp_argmax(pool, m, Pv, [&](const float* v) {
    const float ax = p[0][0] - v[0], ay = p[0][1] - v[1], az = p[0][2] - v[2];
    const float bx = p[1][0] - v[0], by = p[1][1] - v[1], bz = p[1][2] - v[2];
    const float gx = p[2][0] - v[0], gy = p[2][1] - v[1], gz = p[2][2] - v[2];
    const float x = by * gz - bz * gy, y = bz * gx - bx * gz, z = bx * gy - by * gx;
    return (ax * x + ay * y) + az * z;
  });
  for (int a = 0; a < 3; ++a) p[3][a] = pool[i4 * 3 + a];

  float inner[3];
  for (int a = 0; a < 3; ++a) inner[a] = (((p[0][a] + p[1][a]) + p[2][a]) + p[3][a]) * 0.25f;
  const bool any_vert = cnt > 0, enough = cnt >= 4;
  const int tets[4][3] = {{0, 1, 2}, {0, 1, 3}, {0, 2, 3}, {1, 2, 3}};
  float* out = planes_out + (size_t)cand * 32;
  for (int f = 0; f < 4; ++f) {
    const float* fa = p[tets[f][0]];
    const float* fb = p[tets[f][1]];
    const float* fc = p[tets[f][2]];
    const float ux = fb[0] - fa[0], uy = fb[1] - fa[1], uz = fb[2] - fa[2];
    const float wx = fc[0] - fa[0], wy = fc[1] - fa[1], wz = fc[2] - fa[2];
    float nx = uy * wz - uz * wy, ny = uz * wx - ux * wz, nz = ux * wy - uy * wx;
    const float s = (nx * (inner[0] - fa[0]) + ny * (inner[1] - fa[1])) + nz * (inner[2] - fa[2]);
    if (s > 0) { nx = -nx; ny = -ny; nz = -nz; }
    const float ln = sqrtf((nx * nx + ny * ny) + nz * nz);
    const bool ok = ln > 1e-20f;
    const float den = fmaxf(ln, 1e-30f);
    nx = ok ? nx / den : 0.f; ny = ok ? ny / den : 0.f; nz = ok ? nz / den : 0.f;
    float tmax = -3.4e38f, tmin = 3.4e38f;
    for (int j = lane; j < Pv; j += 32) {
      if (!m[j]) continue;
      const float* v = pool + j * 3;
      const float t = (v[0] * nx + v[1] * ny) + v[2] * nz;
      tmax = fmaxf(tmax, t);
      tmin = fminf(tmin, t);
    }
    tmax = max_reduce(tmax);
    tmin = min_reduce(tmin);
    if (lane == 0) {
      out[f * 4 + 0] = nx; out[f * 4 + 1] = ny; out[f * 4 + 2] = nz;
      out[f * 4 + 3] = -(tmax + 0.0f);
      out[16 + f * 4 + 0] = -nx; out[16 + f * 4 + 1] = -ny; out[16 + f * 4 + 2] = -nz;
      out[16 + f * 4 + 3] = tmin - 0.0f;
      const unsigned char pm = ok && any_vert && enough;
      pmask_out[(size_t)cand * 8 + f] = pm;
      pmask_out[(size_t)cand * 8 + 4 + f] = pm;
    }
  }
}

}  // namespace

extern "C" int surtr_refit(const float* pool, const unsigned char* mask,
                           float* planes, unsigned char* pmask, int N, int Pv,
                           void* stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  if (N > 0)
    refit_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        pool, mask, planes, pmask, N, Pv);
  return (int)cudaGetLastError();
}
