// World transform + narrowphase packing (kernel B5).
//
// Replaces: surtr_tpu/physics/pack_pallas.py `_pack_kernel` (wrapper
// `transform_pack_pallas`). Semantics of the plain version in
// surtr_tpu_torch/physics/pack_cuda.py `transform_pack_reference`: per
// piece, the rotation of its owner's quaternion (rigid.quat_to_mat term for
// term), world corners R v + x, world planes (R n, d - (R n).x), world edge
// directions R e, the 26-DOP support interval [min, max] of the valid
// corners along each of the 13 directions, one packed row in pack_layout
// order [wvx wvy wvz wm | pnx pny pnz pd pm | lod hid | ex ey ez em], and the
// AABB row [lo - margin | hi + margin | center, or BIG for a dead piece].
//
// What bounds it on the card: bytes. Per piece it reads about 230 B of hull
// data and writes (D + 9) floats (476 B at Vh = 8, F = 8, Ne = 3), with some
// 600 flops; at 10k pieces that is ~7 MB, a few microseconds at 3.35 TB/s.
// Design: one thread per piece, everything in registers, no shared memory.
// Each thread writes its own contiguous row, so stores are strided across a
// warp; the row-major table is what the narrowphase wants (a partner's row
// is one contiguous read). Built with -fmad=false: every product and sum is
// rounded once, in the plain version's order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.4e38f;

__global__ void pack_kernel(const float* __restrict__ verts, const uint8_t* __restrict__ vmask,
                            const float* __restrict__ planes, const uint8_t* __restrict__ pmask,
                            const float* __restrict__ edges, const uint8_t* __restrict__ emask,
                            const float* __restrict__ q, const float* __restrict__ x,
                            const uint8_t* __restrict__ pvalid, const float* __restrict__ dop,
                            int Np, int Vh, int F, int Ne, float margin,
                            float* __restrict__ packed, float* __restrict__ aabb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Np) return;
  const int D = 4 * Vh + 5 * F + 26 + 4 * Ne;
  float* out = packed + (size_t)i * D;

  const float qw = q[i * 4 + 0], qx = q[i * 4 + 1], qy = q[i * 4 + 2], qz = q[i * 4 + 3];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float r00 = 1.0f - 2.0f * (yy + zz), r01 = 2.0f * (xy - wz), r02 = 2.0f * (xz + wy);
  const float r10 = 2.0f * (xy + wz), r11 = 1.0f - 2.0f * (xx + zz), r12 = 2.0f * (yz - wx);
  const float r20 = 2.0f * (xz - wy), r21 = 2.0f * (yz + wx), r22 = 1.0f - 2.0f * (xx + yy);
  const float x0 = x[i * 3 + 0], y0 = x[i * 3 + 1], z0 = x[i * 3 + 2];

  float d[13][3];
#pragma unroll
  for (int a = 0; a < 13; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) d[a][c] = dop[a * 3 + c];

  float lod[13], hid[13];
#pragma unroll
  for (int a = 0; a < 13; ++a) { lod[a] = BIG; hid[a] = -BIG; }
  float lox = BIG, loy = BIG, loz = BIG, hix = -BIG, hiy = -BIG, hiz = -BIG;

  for (int v = 0; v < Vh; ++v) {
    const float* b = verts + ((size_t)i * Vh + v) * 3;
    const float bx = b[0], by = b[1], bz = b[2];
    const float wvx = ((r00 * bx + r01 * by) + r02 * bz) + x0;
    const float wvy = ((r10 * bx + r11 * by) + r12 * bz) + y0;
    const float wvz = ((r20 * bx + r21 * by) + r22 * bz) + z0;
    const bool m = vmask[(size_t)i * Vh + v] != 0;
    out[v] = wvx;
    out[Vh + v] = wvy;
    out[2 * Vh + v] = wvz;
    out[3 * Vh + v] = m ? 1.0f : 0.0f;
    if (!m) continue;
#pragma unroll
    for (int a = 0; a < 13; ++a) {
      const float t = (wvx * d[a][0] + wvy * d[a][1]) + wvz * d[a][2];
      lod[a] = fminf(lod[a], t);
      hid[a] = fmaxf(hid[a], t);
    }
    lox = fminf(lox, wvx); loy = fminf(loy, wvy); loz = fminf(loz, wvz);
    hix = fmaxf(hix, wvx); hiy = fmaxf(hiy, wvy); hiz = fmaxf(hiz, wvz);
  }

  float* po = out + 4 * Vh;
  for (int f = 0; f < F; ++f) {
    const float* p = planes + ((size_t)i * F + f) * 4;
    const float nx = p[0], ny = p[1], nz = p[2];
    const float wnx = (r00 * nx + r01 * ny) + r02 * nz;
    const float wny = (r10 * nx + r11 * ny) + r12 * nz;
    const float wnz = (r20 * nx + r21 * ny) + r22 * nz;
    po[f] = wnx;
    po[F + f] = wny;
    po[2 * F + f] = wnz;
    po[3 * F + f] = p[3] - ((wnx * x0 + wny * y0) + wnz * z0);
    po[4 * F + f] = pmask[(size_t)i * F + f] ? 1.0f : 0.0f;
  }

  float* dp = po + 5 * F;
#pragma unroll
  for (int a = 0; a < 13; ++a) { dp[a] = lod[a]; dp[13 + a] = hid[a]; }

  float* ep = dp + 26;
  for (int e = 0; e < Ne; ++e) {
    const float* b = edges + ((size_t)i * Ne + e) * 3;
    const float bx = b[0], by = b[1], bz = b[2];
    ep[e] = (r00 * bx + r01 * by) + r02 * bz;
    ep[Ne + e] = (r10 * bx + r11 * by) + r12 * bz;
    ep[2 * Ne + e] = (r20 * bx + r21 * by) + r22 * bz;
    ep[3 * Ne + e] = emask[(size_t)i * Ne + e] ? 1.0f : 0.0f;
  }

  lox = lox - margin; loy = loy - margin; loz = loz - margin;
  hix = hix + margin; hiy = hiy + margin; hiz = hiz + margin;
  const bool pv = pvalid[i] != 0;
  float* ab = aabb + (size_t)i * 9;
  ab[0] = lox; ab[1] = loy; ab[2] = loz;
  ab[3] = hix; ab[4] = hiy; ab[5] = hiz;
  ab[6] = pv ? (lox + hix) * 0.5f : BIG;
  ab[7] = pv ? (loy + hiy) * 0.5f : BIG;
  ab[8] = pv ? (loz + hiz) * 0.5f : BIG;
}

}  // namespace

extern "C" int surtr_pack(const float* verts, const uint8_t* vmask, const float* planes,
                          const uint8_t* pmask, const float* edges, const uint8_t* emask,
                          const float* q, const float* x, const uint8_t* pvalid,
                          const float* dop, int Np, int Vh, int F, int Ne, float margin,
                          float* packed, float* aabb, void* stream) {
  const int threads = 128;
  if (Np > 0)
    pack_kernel<<<(Np + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        verts, vmask, planes, pmask, edges, emask, q, x, pvalid, dop, Np, Vh, F, Ne, margin,
        packed, aabb);
  return (int)cudaGetLastError();
}
