// World transform + narrowphase packing with the owner gather (kernel B5).
//
// Replaces: surtr_tpu/physics/pack_pallas.py `_pack_kernel` (wrapper
// `transform_pack_pallas`). Semantics of the plain version in
// surtr_tpu_torch/physics/pack_cuda.py `transform_pack_owned_reference`: per
// piece, its owner clamped to [0, B) and valid only where the piece is valid
// and its owner is not negative; the rotation of the owner's quaternion
// (rigid.quat_to_mat term for term), world corners R v + x, world planes
// (R n, d - (R n).x), world edge directions R e, the 26-DOP support interval
// [min, max] of the valid corners along each of the 13 directions, one packed
// row in pack_layout order [wvx wvy wvz wm | pnx pny pnz pd pm | lod hid |
// ex ey ez em], and the AABB row [lo - margin | hi + margin | center, or BIG
// for a dead piece].
//
// What bounds it on the card: bytes. Per piece it reads about 300 B of hull
// data, its owner's pose, and writes (D + 9) floats (476 B at Vh = 8, F = 8,
// Ne = 3); at 10k pieces that is ~8 MB, a few microseconds at 3.35 TB/s.
// Design: a group of L lanes per piece (16 for hulls of at most 16 corners
// and faces, else 32), 128 / L pieces a block. The lanes transform the
// corners, planes and edges side by side into the piece's row, staged in
// shared memory; then 16 lanes each fold one 26-DOP direction or one AABB
// axis over the staged corners in corner order (the plain version's min and
// max, the first design's order, so ±0 and BIG come out alike); last, the
// block writes its pieces' contiguous (pieces x D) and (pieces x 9) spans
// with consecutive threads on consecutive floats. Built with -fmad=false:
// every product and sum is rounded once, in the plain version's order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.4e38f;
constexpr int THREADS = 128;

// DIRECT (the general variant, for hulls whose rows pass the shared memory
// a block may take): each group builds its piece's row in place in `packed`
// and its AABB row in `aabb`, with no staging and no block copy.
template <int L, bool DIRECT>
__global__ void __launch_bounds__(THREADS) pack_kernel(
    const float* __restrict__ verts, const uint8_t* __restrict__ vmask,
    const float* __restrict__ planes, const uint8_t* __restrict__ pmask,
    const float* __restrict__ edges, const uint8_t* __restrict__ emask,
    const int* __restrict__ owner, const uint8_t* __restrict__ valid,
    const float* __restrict__ q, const float* __restrict__ x, const float* __restrict__ dop,
    int Np, int B, int Vh, int F, int Ne, float margin, float* __restrict__ packed,
    float* __restrict__ aabb) {
  extern __shared__ float srow[];
  constexpr int PPB = THREADS / L;
  const int D = 4 * Vh + 5 * F + 26 + 4 * Ne;
  const int RS = D + 9;  // a staged piece: its packed row, then its AABB row
  const int grp = threadIdx.x / L, lane = threadIdx.x % L;
  const int base = blockIdx.x * PPB;
  const int n = min(PPB, Np - base);
  const int i = base + grp;
  float* row = DIRECT ? packed + (size_t)i * D : srow + grp * RS;
  float* arow = DIRECT ? aabb + (size_t)i * 9 : row + D;
  const bool live = grp < n;

  int own = 0;
  float r00 = 0, r01 = 0, r02 = 0, r10 = 0, r11 = 0, r12 = 0, r20 = 0, r21 = 0, r22 = 0;
  float x0 = 0, y0 = 0, z0 = 0;
  if (live) {
    own = owner[i];
    const int o = min(max(own, 0), B - 1);
    const float qw = q[o * 4 + 0], qx = q[o * 4 + 1], qy = q[o * 4 + 2], qz = q[o * 4 + 3];
    const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
    const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
    const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
    r00 = 1.0f - 2.0f * (yy + zz); r01 = 2.0f * (xy - wz); r02 = 2.0f * (xz + wy);
    r10 = 2.0f * (xy + wz); r11 = 1.0f - 2.0f * (xx + zz); r12 = 2.0f * (yz - wx);
    r20 = 2.0f * (xz - wy); r21 = 2.0f * (yz + wx); r22 = 1.0f - 2.0f * (xx + yy);
    x0 = x[o * 3 + 0]; y0 = x[o * 3 + 1]; z0 = x[o * 3 + 2];

    for (int v = lane; v < Vh; v += L) {
      const float* b = verts + ((size_t)i * Vh + v) * 3;
      const float bx = b[0], by = b[1], bz = b[2];
      row[v] = ((r00 * bx + r01 * by) + r02 * bz) + x0;
      row[Vh + v] = ((r10 * bx + r11 * by) + r12 * bz) + y0;
      row[2 * Vh + v] = ((r20 * bx + r21 * by) + r22 * bz) + z0;
      row[3 * Vh + v] = vmask[(size_t)i * Vh + v] ? 1.0f : 0.0f;
    }
    float* po = row + 4 * Vh;
    for (int f = lane; f < F; f += L) {
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
    float* ep = row + 4 * Vh + 5 * F + 26;
    for (int e = lane; e < Ne; e += L) {
      const float* b = edges + ((size_t)i * Ne + e) * 3;
      const float bx = b[0], by = b[1], bz = b[2];
      ep[e] = (r00 * bx + r01 * by) + r02 * bz;
      ep[Ne + e] = (r10 * bx + r11 * by) + r12 * bz;
      ep[2 * Ne + e] = (r20 * bx + r21 * by) + r22 * bz;
      ep[3 * Ne + e] = emask[(size_t)i * Ne + e] ? 1.0f : 0.0f;
    }
  }
  __syncwarp();  // a group lies inside one warp (L <= 32)

  if (live) {
    const float* wvx = row;
    const float* wvy = row + Vh;
    const float* wvz = row + 2 * Vh;
    const float* wm = row + 3 * Vh;
    float* dp = row + 4 * Vh + 5 * F;
    for (int t = lane; t < 16; t += L) {
      float lo = BIG, hi = -BIG;
      if (t < 13) {
        const float d0 = dop[t * 3 + 0], d1 = dop[t * 3 + 1], d2 = dop[t * 3 + 2];
        for (int v = 0; v < Vh; ++v) {
          if (wm[v] == 0.0f) continue;
          const float s = (wvx[v] * d0 + wvy[v] * d1) + wvz[v] * d2;
          lo = fminf(lo, s);
          hi = fmaxf(hi, s);
        }
        dp[t] = lo;
        dp[13 + t] = hi;
      } else {
        const int c = t - 13;
        const float* w = row + c * Vh;
        for (int v = 0; v < Vh; ++v) {
          if (wm[v] == 0.0f) continue;
          lo = fminf(lo, w[v]);
          hi = fmaxf(hi, w[v]);
        }
        lo = lo - margin;
        hi = hi + margin;
        const bool pv = valid[i] != 0 && own >= 0;
        arow[c] = lo;
        arow[3 + c] = hi;
        arow[6 + c] = pv ? (lo + hi) * 0.5f : BIG;
      }
    }
  }
  if (DIRECT) return;
  __syncthreads();

  float* pout = packed + (size_t)base * D;
  for (int j = threadIdx.x; j < n * D; j += THREADS) {
    const int p = j / D;
    pout[j] = srow[p * RS + (j - p * D)];
  }
  float* aout = aabb + (size_t)base * 9;
  for (int j = threadIdx.x; j < n * 9; j += THREADS) {
    const int p = j / 9;
    aout[j] = srow[p * RS + D + (j - p * 9)];
  }
}

}  // namespace

// Shared bytes a block stages for hulls of this size (the wrapper takes the
// staged variant up to the 48 KB a launch may take without opting in, and
// the direct one beyond: pack_cuda.stage_bytes and _variant).
static long long pack_smem(int Vh, int F, int Ne) {
  const int L = (Vh <= 16 && F <= 16 && Ne <= 16) ? 16 : 32;
  return (long long)(THREADS / L) * (4LL * Vh + 5LL * F + 26 + 4LL * Ne + 9) * (long long)sizeof(float);
}

extern "C" long long surtr_pack_stage_bytes(int Vh, int F, int Ne) {
  return pack_smem(Vh, F, Ne);
}

extern "C" int surtr_pack(const float* verts, const uint8_t* vmask, const float* planes,
                          const uint8_t* pmask, const float* edges, const uint8_t* emask,
                          const int* owner, const uint8_t* valid, const float* q,
                          const float* x, const float* dop, int Np, int B, int Vh, int F,
                          int Ne, float margin, float* packed, float* aabb, int direct,
                          void* stream) {
  if (Np <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool narrow = Vh <= 16 && F <= 16 && Ne <= 16;
  const int ppb = THREADS / (narrow ? 16 : 32);
  const unsigned grid = (unsigned)((Np + ppb - 1) / ppb);
#define SURTR_PACK_ARGS verts, vmask, planes, pmask, edges, emask, owner, valid, q, x, dop, Np, B, \
                        Vh, F, Ne, margin, packed, aabb
  if (direct) {
    if (narrow) pack_kernel<16, true><<<grid, THREADS, 0, s>>>(SURTR_PACK_ARGS);
    else pack_kernel<32, true><<<grid, THREADS, 0, s>>>(SURTR_PACK_ARGS);
  } else {
    const size_t smem = (size_t)pack_smem(Vh, F, Ne);
    if (narrow) pack_kernel<16, false><<<grid, THREADS, smem, s>>>(SURTR_PACK_ARGS);
    else pack_kernel<32, false><<<grid, THREADS, smem, s>>>(SURTR_PACK_ARGS);
  }
#undef SURTR_PACK_ARGS
  return (int)cudaGetLastError();
}
