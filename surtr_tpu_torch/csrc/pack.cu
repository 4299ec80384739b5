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
//
// Rows past the 48 KB a block takes without opting in (Vh > 723 at F = 26,
// Ne = 3) take the wide variant, pack_wide_kernel: a warp a piece, as many
// pieces a CTA as a third of the SM's opt-in shared memory holds (3 at Vh =
// 768), so at least three CTAs share an SM. The CTA first copies its
// pieces' raw corners (one contiguous span, 16-byte loads where aligned)
// and corner masks into shared memory; each lane then transforms the
// corners v = lane (mod 32) into the staged row and folds them at once into
// its 13 direction and 3 axis intervals in registers; five xor-shuffle
// steps complete the folds over the warp; last, the CTA writes its packed
// rows and AABB rows as two contiguous spans, by 16-byte stores where
// aligned (each span is staged at the global span's offset mod 16 bytes).
// Where one piece's CTA with its raw corners passes a block's 232,448 B (Vh
// > 7,989 at F = 26, Ne = 3) the lanes read the corners and masks in place.
// The card's fminf / fmaxf order -0 below +0 (a zero minimum is -0 when any
// operand is -0, a zero maximum +0 when any is +0), so any fold order gives
// the serial walk's result; the plain version orders the zeros alike. Unlike
// fminf, the wide folds keep a NaN support, as torch.amin / amax do: a
// lane's NaN bits are OR-ed over the warp and a NaN interval is written as
// NaN (the staged and direct kernels drop it, ROADMAP C17). Only a row past
// the opt-in room (Vh > 14,482 at F = 26, Ne = 3) takes the direct variant.
// Measured by tools/time_b5_b8.py --limits on an NVIDIA H100 80GB HBM3 at
// 700 W, the direct kernel in the same call: 0.0134 ms at Np = 1,000, Vh =
// 768 against 0.045 (the bytes bound 0.0068).

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

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;          // opt-in dynamic shared memory a block, H100
constexpr int WIDE_ROOM = MAX_SMEM / 3;   // the wide variant's shared memory at most
constexpr int WIDE_PIECES = 8;            // pieces (warps) a wide CTA at most

__host__ __device__ inline long long ru4(long long n) { return (n + 3) & ~3LL; }

// Floats of a wide CTA of p pieces: the packed span, the AABB span (each
// with 3 floats of room to match the global span's alignment) and, when
// the raw corners are staged, their span (likewise) and the corner masks'
// bytes.
__host__ __device__ inline long long wide_floats(int Vh, int F, int Ne, int p, bool stage) {
  const long long D = 4LL * Vh + 5LL * F + 26 + 4LL * Ne;
  return ru4(p * D + 3) + ru4(9LL * p + 3)
      + (stage ? ru4(3LL * Vh * p + 3) + ru4((1LL * p * Vh + 3) / 4) : 0);
}

// Whether a wide CTA stages its raw corners: where one piece's CTA with
// them fits a block's shared memory (Vh <= 7,989 at F = 26, Ne = 3).
inline bool wide_stage(int Vh, int F, int Ne) {
  return wide_floats(Vh, F, Ne, 1, true) * (long long)sizeof(float) <= MAX_SMEM;
}

// Pieces a wide CTA takes: the most, up to WIDE_PIECES, whose floats fit
// WIDE_ROOM; 1 when one does not.
inline int wide_pieces(int Vh, int F, int Ne) {
  const bool st = wide_stage(Vh, F, Ne);
  int p = WIDE_PIECES;
  while (p > 1 && wide_floats(Vh, F, Ne, p, st) * (long long)sizeof(float) > WIDE_ROOM) --p;
  return p;
}

// Copies n floats between global and shared memory, the CTA's threads side
// by side: 16-byte moves where both ends share their offset mod 16 bytes.
__device__ __forceinline__ void copy_span(float* __restrict__ dst, const float* __restrict__ src,
                                          long long n, int tid, int nthr) {
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst), sa = reinterpret_cast<uintptr_t>(src);
  long long head = n;
  if (((da ^ sa) & 15) == 0) head = min(n, (long long)(((16 - (da & 15)) & 15) >> 2));
  for (long long j = tid; j < head; j += nthr) dst[j] = src[j];
  const long long n4 = (n - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
#pragma unroll 4
  for (long long k = tid; k < n4; k += nthr) d4[k] = s4[k];
  for (long long j = head + 4 * n4 + tid; j < n; j += nthr) dst[j] = src[j];
}

// The float offset (0-3) at which a shared span must start to share a
// global span's offset mod 16 bytes.
__device__ __forceinline__ int align_shift(const float* g) {
  return (int)((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

template <bool STAGE>
__global__ void __launch_bounds__(32 * WIDE_PIECES) pack_wide_kernel(
    const float* __restrict__ verts, const uint8_t* __restrict__ vmask,
    const float* __restrict__ planes, const uint8_t* __restrict__ pmask,
    const float* __restrict__ edges, const uint8_t* __restrict__ emask,
    const int* __restrict__ owner, const uint8_t* __restrict__ valid,
    const float* __restrict__ q, const float* __restrict__ x, const float* __restrict__ dop,
    int Np, int B, int Vh, int F, int Ne, float margin, float* __restrict__ packed,
    float* __restrict__ aabb, int ppb) {
  extern __shared__ __align__(16) float smem[];
  const int D = 4 * Vh + 5 * F + 26 + 4 * Ne;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int w = tid >> 5, lane = tid & 31;
  const long long base = (long long)blockIdx.x * ppb;
  const int n = (int)min((long long)ppb, (long long)Np - base);
  float* gp = packed + base * D;
  float* ga = aabb + base * 9;
  const float* gv = verts + base * 3 * Vh;
  const long long A = ru4((long long)ppb * D + 3);
  const long long R = A + ru4(9LL * ppb + 3);
  const long long M = R + ru4(3LL * Vh * ppb + 3);
  float* sp = smem + align_shift(gp);
  float* sa = smem + A + align_shift(ga);
  const uint8_t* gm = vmask + base * Vh;
  const float* sr = gv;
  const uint8_t* sm = gm;
  if (STAGE) {
    // 1. The CTA's raw corners and corner masks, each one contiguous span.
    float* r = smem + R + align_shift(gv);
    uint8_t* mk = reinterpret_cast<uint8_t*>(smem + M);
    copy_span(r, gv, (long long)n * 3 * Vh, tid, nthr);
#pragma unroll 4
    for (int j = tid; j < n * Vh; j += nthr) mk[j] = gm[j];
    __syncthreads();
    sr = r;
    sm = mk;
  }

  if (w < n) {   // a warp a piece
    const long long i = base + w;
    float* row = sp + (long long)w * D;
    float* arow = sa + w * 9;
    const float* rv = sr + (long long)w * 3 * Vh;
    const uint8_t* rm = sm + (long long)w * Vh;
    const int own = owner[i];
    const int o = min(max(own, 0), B - 1);
    const float qw = q[o * 4 + 0], qx = q[o * 4 + 1], qy = q[o * 4 + 2], qz = q[o * 4 + 3];
    const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
    const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
    const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
    const float r00 = 1.0f - 2.0f * (yy + zz), r01 = 2.0f * (xy - wz), r02 = 2.0f * (xz + wy);
    const float r10 = 2.0f * (xy + wz), r11 = 1.0f - 2.0f * (xx + zz), r12 = 2.0f * (yz - wx);
    const float r20 = 2.0f * (xz - wy), r21 = 2.0f * (yz + wx), r22 = 1.0f - 2.0f * (xx + yy);
    const float x0 = x[o * 3 + 0], y0 = x[o * 3 + 1], z0 = x[o * 3 + 2];
    float d[39];
#pragma unroll
    for (int t = 0; t < 39; ++t) d[t] = dop[t];

    // 2. Corners v = lane (mod 32): the staged row, and the folds in
    // registers (13 directions, then the 3 axes); bit t of nanb marks a
    // NaN seen by fold t.
    float lo[16], hi[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      lo[t] = BIG;
      hi[t] = -BIG;
    }
    unsigned nanb = 0u;
    for (int v = lane; v < Vh; v += 32) {
      const float bx = rv[3 * v], by = rv[3 * v + 1], bz = rv[3 * v + 2];
      const float px = ((r00 * bx + r01 * by) + r02 * bz) + x0;
      const float py = ((r10 * bx + r11 * by) + r12 * bz) + y0;
      const float pz = ((r20 * bx + r21 * by) + r22 * bz) + z0;
      const bool m = rm[v] != 0;
      row[v] = px;
      row[Vh + v] = py;
      row[2 * Vh + v] = pz;
      row[3 * Vh + v] = m ? 1.0f : 0.0f;
      if (!m) continue;
#pragma unroll
      for (int t = 0; t < 13; ++t) {
        const float s = (px * d[3 * t] + py * d[3 * t + 1]) + pz * d[3 * t + 2];
        lo[t] = fminf(lo[t], s);
        hi[t] = fmaxf(hi[t], s);
        if (s != s) nanb |= 1u << t;
      }
      lo[13] = fminf(lo[13], px); hi[13] = fmaxf(hi[13], px);
      lo[14] = fminf(lo[14], py); hi[14] = fmaxf(hi[14], py);
      lo[15] = fminf(lo[15], pz); hi[15] = fmaxf(hi[15], pz);
      if (px != px) nanb |= 1u << 13;
      if (py != py) nanb |= 1u << 14;
      if (pz != pz) nanb |= 1u << 15;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        lo[t] = fminf(lo[t], __shfl_xor_sync(FULL, lo[t], off));
        hi[t] = fmaxf(hi[t], __shfl_xor_sync(FULL, hi[t], off));
      }
    }
    nanb = __reduce_or_sync(FULL, nanb);
    const float qnan = __int_as_float(0x7fffffff);
    float* dp = row + 4 * Vh + 5 * F;
#pragma unroll
    for (int t = 0; t < 13; ++t) {
      if (lane == t) {
        const bool nan = (nanb >> t) & 1u;
        dp[t] = nan ? qnan : lo[t];
        dp[13 + t] = nan ? qnan : hi[t];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (lane == 13 + c) {
        const bool nan = (nanb >> (13 + c)) & 1u;
        const float l = (nan ? qnan : lo[13 + c]) - margin;
        const float h = (nan ? qnan : hi[13 + c]) + margin;
        const bool pv = valid[i] != 0 && own >= 0;
        arow[c] = l;
        arow[3 + c] = h;
        arow[6 + c] = pv ? (l + h) * 0.5f : BIG;
      }
    }

    // 3. Planes and edges, as the staged kernel computes them.
    float* po = row + 4 * Vh;
    for (int f = lane; f < F; f += 32) {
      const float* p = planes + (i * F + f) * 4;
      const float nx = p[0], ny = p[1], nz = p[2];
      const float wnx = (r00 * nx + r01 * ny) + r02 * nz;
      const float wny = (r10 * nx + r11 * ny) + r12 * nz;
      const float wnz = (r20 * nx + r21 * ny) + r22 * nz;
      po[f] = wnx;
      po[F + f] = wny;
      po[2 * F + f] = wnz;
      po[3 * F + f] = p[3] - ((wnx * x0 + wny * y0) + wnz * z0);
      po[4 * F + f] = pmask[i * F + f] ? 1.0f : 0.0f;
    }
    float* ep = row + 4 * Vh + 5 * F + 26;
    for (int e = lane; e < Ne; e += 32) {
      const float* b = edges + (i * Ne + e) * 3;
      const float bx = b[0], by = b[1], bz = b[2];
      ep[e] = (r00 * bx + r01 * by) + r02 * bz;
      ep[Ne + e] = (r10 * bx + r11 * by) + r12 * bz;
      ep[2 * Ne + e] = (r20 * bx + r21 * by) + r22 * bz;
      ep[3 * Ne + e] = emask[i * Ne + e] ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  // 4. The CTA's packed rows and AABB rows, two contiguous spans.
  copy_span(gp, sp, (long long)n * D, tid, nthr);
  copy_span(ga, sa, (long long)n * 9, tid, nthr);
}

int wide_smem_set[2][64] = {};   // the opt-in size set a device: in place, staged

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

// Shared bytes of the wide variant's CTA (pack_cuda.wide_bytes mirrors it).
extern "C" long long surtr_pack_wide_bytes(int Vh, int F, int Ne) {
  return wide_floats(Vh, F, Ne, wide_pieces(Vh, F, Ne), wide_stage(Vh, F, Ne))
      * (long long)sizeof(float);
}

// variant: 0 the staged kernel (a block's rows within 48 KB), 1 the direct
// one (rows built in place), 2 the wide one (a warp a piece, opt-in shared
// memory); one launch.
extern "C" int surtr_pack(const float* verts, const uint8_t* vmask, const float* planes,
                          const uint8_t* pmask, const float* edges, const uint8_t* emask,
                          const int* owner, const uint8_t* valid, const float* q,
                          const float* x, const float* dop, int Np, int B, int Vh, int F,
                          int Ne, float margin, float* packed, float* aabb, int variant,
                          void* stream) {
  if (Np <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool narrow = Vh <= 16 && F <= 16 && Ne <= 16;
  const int ppb = THREADS / (narrow ? 16 : 32);
  const unsigned grid = (unsigned)((Np + ppb - 1) / ppb);
#define SURTR_PACK_ARGS verts, vmask, planes, pmask, edges, emask, owner, valid, q, x, dop, Np, B, \
                        Vh, F, Ne, margin, packed, aabb
  if (variant == 2) {
    const bool st = wide_stage(Vh, F, Ne);
    const int p = wide_pieces(Vh, F, Ne);
    const long long smem = wide_floats(Vh, F, Ne, p, st) * (long long)sizeof(float);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    auto kernel = st ? pack_wide_kernel<true> : pack_wide_kernel<false>;
    if (smem > 48 * 1024) {
      int dev = 0;
      cudaGetDevice(&dev);
      if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
      int& set = wide_smem_set[st][dev];
      if (smem > set) {
        const cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        set = (int)smem;
      }
    }
    kernel<<<(unsigned)((Np + p - 1) / p), 32 * p, (size_t)smem, s>>>(SURTR_PACK_ARGS, p);
  } else if (variant == 1) {
    if (narrow) pack_kernel<16, true><<<grid, THREADS, 0, s>>>(SURTR_PACK_ARGS);
    else pack_kernel<32, true><<<grid, THREADS, 0, s>>>(SURTR_PACK_ARGS);
  } else if (variant == 0) {
    const size_t smem = (size_t)pack_smem(Vh, F, Ne);
    if (narrow) pack_kernel<16, false><<<grid, THREADS, smem, s>>>(SURTR_PACK_ARGS);
    else pack_kernel<32, false><<<grid, THREADS, smem, s>>>(SURTR_PACK_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef SURTR_PACK_ARGS
  return (int)cudaGetLastError();
}
