// Batched K-plane fold of padded convex polytopes (kernel B1).
//
// Replaces: surtr_tpu/ops/clip_pallas.py `_clip_kernel` (wrapper
// `clip_planes_batch_pallas`), the TPU VMEM plane fold. Semantics are those
// of the plain fold in surtr_tpu_torch/ops/clip.py (= the JAX package's
// `clip_poly_plane` folded over the plane list): per face Sutherland-Hodgman
// emission [v if kept][cut point if the edge crosses], truncated to S; cap
// face from <= 3 candidates per face, ordered by atan2 about their centroid,
// bitwise duplicates dropped, truncated to S, written to the first free
// slot; fewer than 4 live faces clears the polytope. (The TPU kernel emits
// a rotation of each loop and orders caps by a pseudo-angle; the cyclic
// order and the polytope are the same.)
//
// What bounds it on the card: not bytes (one polytope is ~5 KB at F=26,
// S=16 and is read and written once) but the serial dependency of the fold:
// every plane step depends on the previous one. The first design (one CTA
// of ceil(F/32) warps per polytope, 5-7 block barriers a step, thread 0
// assembling each cap alone, every step emitting and copying back the whole
// state) took 1.47-1.51 ms for the six calls of a 1k cube decomposition on
// an NVIDIA H100 80GB HBM3 at 700 W. This design:
//  - one warp per polytope, up to 4 polytopes a CTA, one lane per face
//    (faces lane, lane+32, ... beyond 32): every barrier is a __syncwarp,
//    and the 1024-polytope calls run 1024 independent warps;
//  - the state ping-pongs between two face-minor buffers (vertex (f, s, a)
//    at [(s*3 + a)*F + f], conflict-free per lane): no copy-back; each
//    face's `hw` (slots that may be non-zero) bounds the zero fill;
//  - a plane that keeps every vertex (distance <= tol) skips the step when
//    the step is the identity: every face's n_verts in [0, S] and its
//    padding zero (hw <= n), no face of 1-2 vertices, and 0 or >= 4 live
//    faces (tests/test_torch_clip.py `test_plane_that_removes_nothing_...`
//    shows the plain fold returns its input bitwise exactly then);
//  - the cap is assembled in parallel: a warp scan compacts the per-face
//    candidates into a dense pool in pool order (face-major, then slot),
//    every lane sums the centroid over it in float64 and rounds it once
//    (as the plain version does: a float32 sum's order is the device's),
//    one lane per candidate takes atan2 in float64 rounded once to float32
//    (a float32 atan2 differs by an ulp between devices, and a near tie of
//    two angles decides the dedup) and its stable (key, index) rank, and
//    a ballot scan drops adjacent bitwise
//    duplicates, truncates to S and places the cap in the first free face;
//  - the polytope loads 16 values a lane at once, each plane a step ahead.
// Measured on the same card (tools/time_b1_b6.py, the first design in the
// same call): the six decomposition calls 0.77-0.78 ms against 1.69-1.72
// ms, 0.39 against 1.14 ms on the device; the Voronoi pass 1 (1024 x 30
// planes) 0.17 against 0.51 ms, the ACH clip (1 x 88) 0.057 against 0.19.
//
// Exactness: the cut point (a*s_b - b*s_a)/(s_b - s_a) must be bitwise
// sign-symmetric so the two faces sharing an edge produce the same point
// (the cap dedup relies on it). The file is built with -fmad=false, so no
// multiply-add is contracted into an FMA.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CAPS = 3;
constexpr int MAX_WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

// 4-byte words of one polytope's shared state.
__host__ __device__ inline int poly_words(int F, int S) {
  return 6 * S * F        // two vertex buffers
         + 4 * F          // planes
         + 10 * CAPS * F  // per-face candidates (3), dense pool (x, y, z, key), sorted (3)
         + 7 * F;         // n_verts and hw of both buffers, pool counts, offsets, touched
}

__device__ __forceinline__ float sdist(float x, float y, float z, float nx, float ny, float nz,
                                       float d) {
  return ((x * nx + y * ny) + z * nz) + d;
}

// GLOBAL (the general variant, for a polytope whose state passes the shared
// memory of a CTA): the same fold with warp w's state in slice
// blockIdx.x * W + w of a device scratch instead of shared memory, the
// launch taking polytopes b_base, b_base + 1, ... (the entry point launches
// as many batches as its scratch needs).
template <bool GLOBAL>
__global__ void __launch_bounds__(MAX_WARPS * 32)
clip_fold_kernel(const float* __restrict__ fv_in, const int* __restrict__ nv_in,
                 const float* __restrict__ pl_in, const float* __restrict__ cuts,
                 const unsigned char* __restrict__ cmask, int cs, int ms,
                 float* __restrict__ fv_out, int* __restrict__ nv_out, float* __restrict__ pl_out,
                 int N, int F, int S, int K, float tol, int W, float* __restrict__ scratch,
                 int b_base) {
  extern __shared__ float sm[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = (GLOBAL ? b_base : 0) + blockIdx.x * W + w;
  if (b >= N) return;                       // no block barrier below: warps are independent
  const int FS3 = F * S * 3, P = F * CAPS;
  float* const fv0 = (GLOBAL ? scratch + (size_t)blockIdx.x * W * poly_words(F, S) : sm) +
                     (size_t)w * poly_words(F, S);
  float* const fv1 = fv0 + FS3;
  float* pl = fv1 + FS3;
  float* cand = pl + 4 * F;                 // [(q*3 + a)*F + f]
  float* px = cand + 3 * P;
  float* py = px + P;
  float* pz = py + P;
  float* key = pz + P;
  float* sx = key + P;
  float* sy = sx + P;
  float* sz = sy + P;
  int* const nv0 = reinterpret_cast<int*>(sz + P);
  int* const nv1 = nv0 + F;
  int* const hw0 = nv1 + F;
  int* const hw1 = hw0 + F;
  int* pc = hw1 + F;
  int* off = pc + F;
  int* tch = off + F;

  // Load the polytope (16 loads in flight per lane), then each face's hw:
  // the slots up to its last non-zero bit pattern.
  for (int j = lane; j < 4 * F; j += 32) pl[j] = pl_in[(size_t)b * 4 * F + j];
  for (int f = lane; f < F; f += 32) nv0[f] = nv_in[(size_t)b * F + f];
  const float* gin = fv_in + (size_t)b * FS3;
  for (int j0 = 0; j0 < FS3; j0 += 32 * 16) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int j = j0 + 32 * u + lane;
      v[u] = j < FS3 ? gin[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int j = j0 + 32 * u + lane;
      if (j < FS3) {
        const int f = j / (S * 3);
        fv0[(j - f * S * 3) * F + f] = v[u];
      }
    }
  }
  __syncwarp();
  for (int f = lane; f < F; f += 32) {
    int h = 0;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const unsigned bits = __float_as_uint(fv0[(s * 3) * F + f]) |
                            __float_as_uint(fv0[(s * 3 + 1) * F + f]) |
                            __float_as_uint(fv0[(s * 3 + 2) * F + f]);
      h = bits != 0u ? s + 1 : h;
    }
    hw0[f] = h;
    hw1[f] = S;
  }
  __syncwarp();

  // Each step's plane and mask are loaded one step ahead.
  const float* cb = cuts + (size_t)b * cs;
  const unsigned char* mb = cmask + (size_t)b * ms;
  bool m_next = K > 0 && mb[0];
  float4 c_next = K > 0 ? make_float4(cb[0], cb[1], cb[2], cb[3]) : make_float4(0, 0, 0, 0);
  int cur = 0;
  for (int k = 0; k < K; ++k) {
    const bool on = m_next;
    const float nx = c_next.x, ny = c_next.y, nz = c_next.z, d = c_next.w;
    if (k + 1 < K) {
      m_next = mb[k + 1];
      const float* c = cb + (k + 1) * 4;
      c_next = make_float4(c[0], c[1], c[2], c[3]);
    }
    if (!on) continue;                        // masked plane: no-op
    const float* src = cur ? fv1 : fv0;
    float* dst = cur ? fv0 : fv1;
    const int* nvs = cur ? nv1 : nv0;
    int* nvd = cur ? nv0 : nv1;
    const int* hws = cur ? hw1 : hw0;
    int* hwd = cur ? hw0 : hw1;

    // Pass 1: distances. Which faces lose a vertex; is the step the identity?
    bool all_kept = true, canon = true, removed = false;
    int live = 0;
    for (int f = lane; f < F; f += 32) {
      const int n = min(max(nvs[f], 0), S);
      bool t = false;
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        const float ds = sdist(src[(s * 3) * F + f], src[(s * 3 + 1) * F + f],
                               src[(s * 3 + 2) * F + f], nx, ny, nz, d);
        all_kept &= ds <= tol;
        t |= ds > tol;
      }
      tch[f] = t;
      removed |= t;
      canon &= nvs[f] == n && hws[f] <= n && n != 1 && n != 2;
      live += n >= 3;
    }
    all_kept = __all_sync(FULL, all_kept);
    canon = __all_sync(FULL, canon);
    const bool any_removed = __any_sync(FULL, removed);
    live = __reduce_add_sync(FULL, live);
    if (all_kept && canon && (live >= 4 || live == 0)) continue;

    // Pass 2: emission into the other buffer and cap candidates, per face.
    for (int f = lane; f < F; f += 32) {
      const int n = min(max(nvs[f], 0), S);
      const bool t = tch[f];
      int cnt = 0, q = 0;
      if (n > 0) {
        const float x0 = src[f], y0 = src[F + f], z0 = src[2 * F + f];
        const float d0 = sdist(x0, y0, z0, nx, ny, nz, d);
        float vx = x0, vy = y0, vz = z0, ds = d0;
        for (int s = 0; s < n; ++s) {
          const bool last = s + 1 == n;
          const float wx = last ? x0 : src[((s + 1) * 3) * F + f];
          const float wy = last ? y0 : src[((s + 1) * 3 + 1) * F + f];
          const float wz = last ? z0 : src[((s + 1) * 3 + 2) * F + f];
          const float dn = last ? d0 : sdist(wx, wy, wz, nx, ny, nz, d);
          const bool kept = ds <= tol;
          const bool cross = (ds < -tol && dn > tol) || (ds > tol && dn < -tol);
          if (kept) {
            if (cnt < S) {
              dst[(cnt * 3) * F + f] = vx;
              dst[(cnt * 3 + 1) * F + f] = vy;
              dst[(cnt * 3 + 2) * F + f] = vz;
            }
            ++cnt;
          }
          float ax = vx, ay = vy, az = vz;
          if (cross) {
            const float den = dn - ds;
            const float safe = fabsf(den) > 1e-30f ? den : 1.0f;
            ax = (vx * dn - wx * ds) / safe;
            ay = (vy * dn - wy * ds) / safe;
            az = (vz * dn - wz * ds) / safe;
            if (cnt < S) {
              dst[(cnt * 3) * F + f] = ax;
              dst[(cnt * 3 + 1) * F + f] = ay;
              dst[(cnt * 3 + 2) * F + f] = az;
            }
            ++cnt;
          }
          if (any_removed && (cross || (fabsf(ds) <= tol && t))) {
            if (q < CAPS) {
              cand[(q * 3) * F + f] = ax;
              cand[(q * 3 + 1) * F + f] = ay;
              cand[(q * 3 + 2) * F + f] = az;
            }
            ++q;
          }
          vx = wx; vy = wy; vz = wz; ds = dn;
        }
      }
      const int n_out = min(cnt, S);
      for (int s = n_out; s < hwd[f]; ++s) {
        dst[(s * 3) * F + f] = 0.0f;
        dst[(s * 3 + 1) * F + f] = 0.0f;
        dst[(s * 3 + 2) * F + f] = 0.0f;
      }
      hwd[f] = n_out;
      nvd[f] = n_out >= 3 ? n_out : 0;
      pc[f] = min(q, CAPS);
    }
    __syncwarp();

    if (any_removed) {
      // Dense pool in pool order: a warp scan of the per-face counts.
      int carry = 0;
      for (int base = 0; base < F; base += 32) {
        const int f = base + lane;
        const int v = f < F ? pc[f] : 0;
        int inc = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, inc, o);
          if (lane >= o) inc += y;
        }
        if (f < F) off[f] = carry + inc - v;
        carry += __shfl_sync(FULL, inc, 31);
      }
      const int cnt = carry;
      for (int f = lane; f < F; f += 32)
        for (int q = 0; q < pc[f]; ++q) {
          const int i = off[f] + q;
          px[i] = cand[(q * 3) * F + f];
          py[i] = cand[(q * 3 + 1) * F + f];
          pz[i] = cand[(q * 3 + 2) * F + f];
        }
      __syncwarp();
      // Centroid (every lane, a float64 sum rounded once), basis.
      double cxs = 0.0, cys = 0.0, czs = 0.0;
#pragma unroll 4
      for (int i = 0; i < cnt; ++i) {
        cxs += px[i];
        cys += py[i];
        czs += pz[i];
      }
      const float fc = (float)(cnt > 1 ? cnt : 1);
      const float ccx = __double2float_rn(cxs) / fc, ccy = __double2float_rn(cys) / fc,
                  ccz = __double2float_rn(czs) / fc;
      const float ln = fmaxf(sqrtf((nx * nx + ny * ny) + nz * nz), 1e-30f);
      const float ux_n = nx / ln, uy_n = ny / ln, uz_n = nz / ln;
      const float aax = fabsf(ux_n), aay = fabsf(uy_n), aaz = fabsf(uz_n);
      // argmin |n| (first of ties) -> one-hot e; u = e x n; v = n x u.
      int axis = 0;
      if (aay < aax) axis = 1;
      if (aaz < (axis == 0 ? aax : aay)) axis = 2;
      const float ex = axis == 0, ey = axis == 1, ez = axis == 2;
      float ux = ey * uz_n - ez * uy_n;
      float uy = ez * ux_n - ex * uz_n;
      float uz = ex * uy_n - ey * ux_n;
      const float ul = fmaxf(sqrtf((ux * ux + uy * uy) + uz * uz), 1e-30f);
      ux /= ul; uy /= ul; uz /= ul;
      const float vx = uy_n * uz - uz_n * uy;
      const float vy = uz_n * ux - ux_n * uz;
      const float vz = ux_n * uy - uy_n * ux;
      for (int i = lane; i < cnt; i += 32) {
        const float rx = px[i] - ccx, ry = py[i] - ccy, rz = pz[i] - ccz;
        const float pu = (rx * ux + ry * uy) + rz * uz;
        const float pv = (rx * vx + ry * vy) + rz * vz;
        key[i] = __double2float_rn(atan2((double)pv, (double)pu));
      }
      __syncwarp();
      // Stable rank by (key, pool index) -> the angle-sorted list.
      for (int i = lane; i < cnt; i += 32) {
        const float ki = key[i];
        int r = 0;
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          const float kj = key[j];
          r += (kj < ki) || (kj == ki && j < i);
        }
        sx[r] = px[i];
        sy[r] = py[i];
        sz[r] = pz[i];
      }
      __syncwarp();
      // Adjacent bitwise duplicates out, truncate to S, first free face.
      int kept_all = 0, ff = -1;
      for (int base = 0; base < cnt; base += 32) {
        const int r = base + lane;
        const bool keep = r < cnt && !(r > 0 && sx[r] == sx[r - 1] && sy[r] == sy[r - 1] &&
                                       sz[r] == sz[r - 1]);
        kept_all += __popc(__ballot_sync(FULL, keep));
      }
      for (int base = 0; base < F; base += 32) {
        const int f = base + lane;
        const unsigned m = __ballot_sync(FULL, f < F && nvd[f] == 0);
        if (ff < 0 && m) ff = base + __ffs(m) - 1;
      }
      const int ncap = min(kept_all, S);
      if (ncap >= 3 && ff >= 0) {
        const int hw_old = hwd[ff];
        int at = 0;
        for (int base = 0; base < cnt; base += 32) {
          const int r = base + lane;
          const bool keep = r < cnt && !(r > 0 && sx[r] == sx[r - 1] && sy[r] == sy[r - 1] &&
                                         sz[r] == sz[r - 1]);
          const unsigned m = __ballot_sync(FULL, keep);
          const int pos = at + __popc(m & ((1u << lane) - 1));
          if (keep && pos < S) {
            dst[(pos * 3) * F + ff] = sx[r];
            dst[(pos * 3 + 1) * F + ff] = sy[r];
            dst[(pos * 3 + 2) * F + ff] = sz[r];
          }
          at += __popc(m);
        }
        for (int s = ncap + lane; s < hw_old; s += 32) {
          dst[(s * 3) * F + ff] = 0.0f;
          dst[(s * 3 + 1) * F + ff] = 0.0f;
          dst[(s * 3 + 2) * F + ff] = 0.0f;
        }
        __syncwarp();
        if (lane == 0) {
          nvd[ff] = ncap;
          hwd[ff] = ncap;
          pl[ff * 4 + 0] = nx;
          pl[ff * 4 + 1] = ny;
          pl[ff * 4 + 2] = nz;
          pl[ff * 4 + 3] = d;
        }
      }
      __syncwarp();
    }

    // Commit: fewer than 4 live faces clears the polytope.
    int lv = 0;
    for (int f = lane; f < F; f += 32) lv += nvd[f] >= 3;
    lv = __reduce_add_sync(FULL, lv);
    if (lv < 4)
      for (int f = lane; f < F; f += 32) nvd[f] = 0;
    cur ^= 1;
    __syncwarp();
  }

  float* gout = fv_out + (size_t)b * FS3;
#pragma unroll 8
  for (int j = lane; j < FS3; j += 32) {
    const int f = j / (S * 3);
    gout[j] = (cur ? fv1 : fv0)[(j - f * S * 3) * F + f];
  }
  for (int j = lane; j < 4 * F; j += 32) pl_out[(size_t)b * 4 * F + j] = pl[j];
  for (int f = lane; f < F; f += 32) nv_out[(size_t)b * F + f] = (cur ? nv1 : nv0)[f];
}

// Dynamic shared memory the kernel is cleared for, per device (a function
// attribute belongs to the current device).
constexpr int MAX_DEVICES = 64;
int smem_set[MAX_DEVICES] = {};

}  // namespace

// cuts (N, K, 4) and cmask (N, K) may have any row stride (cs, ms elements).
extern "C" int surtr_clip_fold(const float* fv, const int* nv, const float* pl,
                               const float* cuts, const unsigned char* cmask, int cs, int ms,
                               float* ofv, int* onv, float* opl, int N, int F,
                               int S, int K, float tol, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const size_t per = (size_t)poly_words(F, S) * 4;
  int W = (int)(232448 / per);
  W = W < 1 ? 1 : (W > MAX_WARPS ? MAX_WARPS : W);
  if (W > N) W = N;
  const size_t smem = per * W;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if ((int)smem > 48 * 1024 && (int)smem > smem_set[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        clip_fold_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = (int)smem;
  }
  clip_fold_kernel<false><<<(N + W - 1) / W, 32 * W, smem, (cudaStream_t)stream>>>(
      fv, nv, pl, cuts, cmask, cs, ms, ofv, onv, opl, N, F, S, K, tol, W, nullptr, 0);
  return (int)cudaGetLastError();
}

// Bytes of one polytope's fold state (clip_cuda.poly_bytes mirrors it).
extern "C" long long surtr_clip_fold_poly_bytes(int F, int S) {
  return (long long)poly_words(F, S) * 4;
}

// The global variant (any F and S): scratch holds `slots` * poly_words(F, S)
// floats (clip_cuda.poly_bytes), slots a multiple of MAX_WARPS; a launch a
// batch of `slots` polytopes, counted in *launched.
extern "C" int surtr_clip_fold_global(const float* fv, const int* nv, const float* pl,
                                      const float* cuts, const unsigned char* cmask, int cs,
                                      int ms, float* ofv, int* onv, float* opl, int N, int F,
                                      int S, int K, float tol, float* scratch, int slots,
                                      int* launched, void* stream) {
  *launched = 0;
  if (N <= 0) return (int)cudaGetLastError();
  if (slots < MAX_WARPS || slots % MAX_WARPS) return (int)cudaErrorInvalidValue;
  for (int b0 = 0; b0 < N; b0 += slots) {
    const int n = N - b0 < slots ? N - b0 : slots;
    clip_fold_kernel<true><<<(n + MAX_WARPS - 1) / MAX_WARPS, 32 * MAX_WARPS, 0,
                             (cudaStream_t)stream>>>(fv, nv, pl, cuts, cmask, cs, ms, ofv, onv,
                                                     opl, N, F, S, K, tol, MAX_WARPS, scratch,
                                                     b0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launched;
  }
  return 0;
}
