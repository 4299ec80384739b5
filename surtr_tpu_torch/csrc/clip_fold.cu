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
// Where this fold would hold one polytope a CTA or none, the CTA variant
// below (one CTA a polytope); past its per-face state's limit, the global
// variant (this kernel with the state in a device scratch).
//
// Exactness: the cut point (a*s_b - b*s_a)/(s_b - s_a) must be bitwise
// sign-symmetric so the two faces sharing an edge produce the same point
// (the cap dedup relies on it). The file is built with -fmad=false, so no
// multiply-add is contracted into an FMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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

// GLOBAL (the global variant, for a polytope whose per-face state passes
// even the CTA variant's shared memory, F > 2,131): the same fold with
// warp w's state in slice
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

// ---------------------------------------------------------------------------
// The CTA variant: one CTA a polytope, for the (F, S) where the shared fold
// would hold one polytope a CTA (measured slower there, PERF.md) or none.
// The same fold (emission, cap and commit as above, bit for bit), with nw =
// 16 warps (32 past F = 512: 16 measured faster than 8 or 32 at F = 256).
// Warp w owns faces w, w + nw, w + 2 nw, ... (lane l the l-th of each 32),
// so the few live faces, which lie at low indices, spread over the warps,
// one or two a warp; a warp takes its live faces one after another with a
// lane a slot: a face's distances, kept and crossing flags and cut points
// in parallel, its emission positions by a warp scan, its cap candidates
// by a ballot, its zero fill in parallel. The cap is assembled by warp 0
// alone, as the shared fold's warp does (a warp scan of the per-face
// candidate counts into the dense pool in pool order, the float64 centroid
// rounded once, a lane a candidate for the float64 atan2 and the stable
// (key, index) rank, ballots for the dedup, the truncation to S and the
// placement), while the other warps wait at the commit. Each block-wide
// vote (the step's count, or and and; the first free face; the commit's
// count) is one barrier: warp reductions, one packed word a warp, read back
// a lane a warp. The per-face counts lie at f + f / 32, so the 32 lanes of
// a warp, which own faces nw apart, touch 32 banks; which 32-face chunks
// hold candidates reaches warp 0 as a bitmask.
// What bounds it: not bytes (13 MB in and out at F = 256, S = 32, 64
// polytopes: 4 µs of the card's bandwidth) but each polytope's serial chain
// of plane steps: a step that cuts costs a few thousand cycles, most of
// them the cap's (probed with clock64, PERF.md).
// State: the per-face counts and cap work in shared memory (cta_aux_words)
// and the two vertex buffers (cta_vert_words), face-major as the polytope
// lies in memory (a lane a slot reads 3 words apart: no bank conflicts),
// in shared memory too (SHARED) where both fit a CTA, the polytope then
// copied in by cp.async and out by 16-byte stores; else the vertex buffers
// lie in the block's slice of a device scratch (the block walking
// polytopes b, b + gridDim.x, ...). Planes are copied to the output at
// load, and a cap's plane is written there by warp 0.
constexpr int RED = 2 * 64 + 16 + 16;   // vote words (two sets), chunk bitmask, the cap's flag

// Words of one per-face array, face f at f + f / 32.
__host__ __device__ inline int face_words(int F) { return F + (F >> 5) + 1; }

__host__ __device__ inline long long cta_aux_words(int F) {
  return 6LL * face_words(F)   // n_verts and hw of both buffers, pool counts, touched
         + 9LL * F             // per-face candidates (3), later the sorted cap list
         + 12LL * F            // dense pool (x, y, z, key)
         + RED;
}

__device__ __forceinline__ int fi(int f) { return f + (f >> 5); }

// Two face-major vertex buffers, each starting 16-byte aligned (8 words of
// room).
__host__ __device__ inline long long cta_vert_words(int F, int S) {
  return 6LL * S * F + 8;
}

// Block-wide sum, or, and and min in one barrier (up to 32 warps): each warp
// reduces its own, lane 0 writes one packed word (sum < 2^29, or, and) and
// the minimum, and after the barrier every warp reduces the 32 words, a
// lane a word. The words alternate between two sets by `phase`, so a later
// vote never overwrites what a slow warp still reads.
__device__ __forceinline__ int4 block_vote(int* words, int& phase, int sum, bool orv, bool andv,
                                           int minv) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int* const ws = words + 64 * (phase & 1);
  ++phase;
  sum = __reduce_add_sync(FULL, sum);
  const bool o = __any_sync(FULL, orv), n = __all_sync(FULL, andv);
  minv = __reduce_min_sync(FULL, minv);
  if (lane == 0) {
    ws[w] = sum | (o ? 1 << 29 : 0) | (n ? 1 << 30 : 0);
    ws[32 + w] = minv;
  }
  __syncthreads();
  const bool mine = lane < (int)(blockDim.x >> 5);
  const int x = mine ? ws[lane] : 1 << 30;
  return make_int4(__reduce_add_sync(FULL, x & ((1 << 29) - 1)),
                   __any_sync(FULL, (x >> 29) & 1), __all_sync(FULL, (x >> 30) & 1),
                   __reduce_min_sync(FULL, mine ? ws[32 + lane] : 0x7fffffff));
}

// 16 bytes from device to shared memory without a register (cp.async), and
// the wait for all of a thread's copies.
__device__ __forceinline__ void copy16_async(float* smem_dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
#else
  memcpy(smem_dst, src, 16);
#endif
}

__device__ __forceinline__ void copy4_async(float* smem_dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
#else
  memcpy(smem_dst, src, 4);
#endif
}

__device__ __forceinline__ void copy_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

__device__ __forceinline__ float* align16(float* p) {
  return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(p) + 15) & ~uintptr_t(15));
}

template <bool SHARED>
__global__ void __launch_bounds__(1024)
clip_cta_kernel(const float* __restrict__ fv_in, const int* __restrict__ nv_in,
                const float* __restrict__ pl_in, const float* __restrict__ cuts,
                const unsigned char* __restrict__ cmask, int cs, int ms,
                float* __restrict__ fv_out, int* __restrict__ nv_out, float* __restrict__ pl_out,
                int N, int F, int S, int K, float tol, float* __restrict__ scratch) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, w = tid >> 5, nw = nt >> 5;
  const int S3 = S * 3, FS3 = F * S3, P = F * CAPS;
  int* const words = reinterpret_cast<int*>(sm);    // block votes
  unsigned* const chunks = reinterpret_cast<unsigned*>(words + 128);   // faces 32c.. with candidates
  int* const placed = words + 144;                  // 1 where the step placed a cap
  const int FW = face_words(F);
  int* const nv0 = words + RED;                     // per-face arrays: face f at fi(f)
  int* const nv1 = nv0 + FW;
  int* const hw0 = nv1 + FW;
  int* const hw1 = hw0 + FW;
  int* const pc = hw1 + FW;
  int* const tch = pc + FW;
  float* const cand = reinterpret_cast<float*>(tch + FW);   // [(q*3 + a)*F + f]
  float* const sx = cand;                                   // the sorted cap, in cand's room
  float* const sy = sx + P;
  float* const sz = sy + P;
  float* const px = cand + 3 * P;
  float* const py = px + P;
  float* const pz = py + P;
  float* const key = pz + P;
  // Vertex (f, s, a) at [f * S3 + s * 3 + a].
  float* const fv0 = align16(SHARED ? key + P
                                    : scratch + (size_t)blockIdx.x * cta_vert_words(F, S));
  float* const fv1 = align16(fv0 + FS3);
  int phase = 0;
  if (tid < 16) chunks[tid] = 0u;

  for (int b = blockIdx.x; b < N; b += gridDim.x) {
    float* const plo = pl_out + (size_t)b * 4 * F;
    for (int j = tid; j < 4 * F; j += nt) plo[j] = pl_in[(size_t)b * 4 * F + j];
    for (int f = tid; f < F; f += nt) nv0[fi(f)] = nv_in[(size_t)b * F + f];
    const float* gin = fv_in + (size_t)b * FS3;
    if (SHARED) {
      if ((reinterpret_cast<uintptr_t>(gin) & 15) == 0) {
        for (int j = 4 * tid; j + 3 < FS3; j += 4 * nt) copy16_async(fv0 + j, gin + j);
        for (int j = (FS3 & ~3) + tid; j < FS3; j += nt) copy4_async(fv0 + j, gin + j);
      } else {
        for (int j = tid; j < FS3; j += nt) copy4_async(fv0 + j, gin + j);
      }
      copy_wait_all();
    } else {
      for (int j = tid; j < FS3; j += nt) fv0[j] = gin[j];
    }
    __syncthreads();
    // Each face's hw: the slots up to its last non-zero bit pattern (a thread
    // a face, the slots taken from the lane's own start: no bank conflicts).
    for (int f = tid; f < F; f += nt) {
      int h = 0;
      const float* v = fv0 + f * S3;
      for (int i = 0, s = lane % S; i < S; ++i, s = s + 1 == S ? 0 : s + 1) {
        const unsigned bits = __float_as_uint(v[s * 3]) | __float_as_uint(v[s * 3 + 1]) |
                              __float_as_uint(v[s * 3 + 2]);
        h = bits != 0u && s + 1 > h ? s + 1 : h;
      }
      hw0[fi(f)] = h;
      hw1[fi(f)] = S;
    }
    __syncthreads();

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
      if (!on) continue;                        // masked plane: no-op (uniform)
      const float* src = cur ? fv1 : fv0;
      float* dst = cur ? fv0 : fv1;
      const int* nvs = cur ? nv1 : nv0;
      int* nvd = cur ? nv0 : nv1;
      const int* hws = cur ? hw1 : hw0;
      int* hwd = cur ? hw0 : hw1;

      // Pass 1: distances, a warp a live face and a lane a slot. Which faces
      // lose a vertex; is the step the identity?
      bool all_kept = true, canon = true, removed = false;
      int live = 0;
      for (int c0 = 0; w + nw * c0 < F; c0 += 32) {
        const int f = w + nw * (c0 + lane);
        int n = 0;
        if (f < F) {
          const int nv = nvs[fi(f)];
          n = min(max(nv, 0), S);
          canon &= nv == n && hws[fi(f)] <= n && n != 1 && n != 2;
          live += n >= 3;
        }
        for (unsigned todo = __ballot_sync(FULL, n > 0); todo; todo &= todo - 1) {
          const int l = __ffs(todo) - 1;
          const int fb = w + nw * (c0 + l), nb = __shfl_sync(FULL, n, l);
          const float* sf = src + fb * S3;
          bool t = false;
          for (int s = lane; s < nb; s += 32) {
            const float ds = sdist(sf[s * 3], sf[s * 3 + 1], sf[s * 3 + 2], nx, ny, nz, d);
            all_kept &= ds <= tol;
            t |= ds > tol;
          }
          t = __any_sync(FULL, t);
          removed |= t;
          if (lane == 0) tch[fi(fb)] = t;
        }
      }
      const int4 vote = block_vote(words, phase, live, removed, all_kept && canon, 0);
      if (vote.z && (vote.x >= 4 || vote.x == 0)) continue;
      const bool any_removed = vote.y != 0;

      // Pass 2: emission into the other buffer and cap candidates, a warp a
      // face (live, or with padding to clear) and a lane a slot.
      int lv = 0, free_f = 0x7fffffff;
      for (int c0 = 0; w + nw * c0 < F; c0 += 32) {
        const int f = w + nw * (c0 + lane);
        int n = 0, hw = 0;
        if (f < F) {
          n = min(max(nvs[fi(f)], 0), S);
          hw = hwd[fi(f)];
        }
        int my_out = 0, my_q = 0;
        for (unsigned todo = __ballot_sync(FULL, n > 0 || hw > 0); todo; todo &= todo - 1) {
          const int l = __ffs(todo) - 1;
          const int fb = w + nw * (c0 + l);
          const int nb = __shfl_sync(FULL, n, l), hb = __shfl_sync(FULL, hw, l);
          const bool tb = nb > 0 && tch[fi(fb)];
          const float* sf = src + fb * S3;
          float* df = dst + fb * S3;
          int cnt = 0, q = 0;
          for (int s0 = 0; s0 < nb; s0 += 32) {
            const int s = s0 + lane;
            const bool act = s < nb;
            float vx = 0.0f, vy = 0.0f, vz = 0.0f, ds = 0.0f;
            float ax = 0.0f, ay = 0.0f, az = 0.0f;
            bool kept = false, cross = false;
            if (act) {
              const int sn = s + 1 == nb ? 0 : s + 1;
              vx = sf[s * 3];
              vy = sf[s * 3 + 1];
              vz = sf[s * 3 + 2];
              const float wx = sf[sn * 3], wy = sf[sn * 3 + 1], wz = sf[sn * 3 + 2];
              ds = sdist(vx, vy, vz, nx, ny, nz, d);
              const float dn = sdist(wx, wy, wz, nx, ny, nz, d);
              kept = ds <= tol;
              cross = (ds < -tol && dn > tol) || (ds > tol && dn < -tol);
              ax = vx; ay = vy; az = vz;
              if (cross) {
                const float den = dn - ds;
                const float safe = fabsf(den) > 1e-30f ? den : 1.0f;
                ax = (vx * dn - wx * ds) / safe;
                ay = (vy * dn - wy * ds) / safe;
                az = (vz * dn - wz * ds) / safe;
              }
            }
            const int e = (int)kept + (int)cross;
            int inc = e;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const int y = __shfl_up_sync(FULL, inc, o);
              if (lane >= o) inc += y;
            }
            const int pos = cnt + inc - e;
            if (kept && pos < S) {
              df[pos * 3] = vx;
              df[pos * 3 + 1] = vy;
              df[pos * 3 + 2] = vz;
            }
            if (cross && pos + kept < S) {
              df[(pos + kept) * 3] = ax;
              df[(pos + kept) * 3 + 1] = ay;
              df[(pos + kept) * 3 + 2] = az;
            }
            const bool cf = any_removed && act && (cross || (fabsf(ds) <= tol && tb));
            const unsigned cm = __ballot_sync(FULL, cf);
            const int qi = q + __popc(cm & ((1u << lane) - 1));
            if (cf && qi < CAPS) {
              cand[(qi * 3) * F + fb] = ax;
              cand[(qi * 3 + 1) * F + fb] = ay;
              cand[(qi * 3 + 2) * F + fb] = az;
            }
            q += __popc(cm);
            cnt += __shfl_sync(FULL, inc, 31);
          }
          const int n_out = min(cnt, S);
          for (int s = n_out + lane; s < hb; s += 32) {
            df[s * 3] = 0.0f;
            df[s * 3 + 1] = 0.0f;
            df[s * 3 + 2] = 0.0f;
          }
          if (lane == l) {
            my_out = n_out;
            my_q = q;
          }
        }
        if (f < F) {
          hwd[fi(f)] = my_out;
          nvd[fi(f)] = my_out >= 3 ? my_out : 0;
          pc[fi(f)] = min(my_q, CAPS);
          lv += my_out >= 3;
          if (my_out < 3) free_f = min(free_f, f);
          if (my_q > 0) atomicOr(&chunks[f >> 10], 1u << ((f >> 5) & 31));
        }
      }

      if (any_removed) {                        // uniform
        const int ff = block_vote(words, phase, 0, false, true, free_f).w;
        if (w == 0) {
          // Dense pool in pool order: a warp scan of the per-face counts over
          // the 32-face chunks that hold candidates, in order.
          int cnt = 0;
          for (int wd = 0; wd * 1024 < F; ++wd) {
            unsigned cm = chunks[wd];
            __syncwarp();
            if (lane == 0) chunks[wd] = 0u;
            for (; cm; cm &= cm - 1) {
              const int f = (wd * 32 + __ffs(cm) - 1) * 32 + lane;
              const int v = f < F ? pc[fi(f)] : 0;
              int inc = v;
#pragma unroll
              for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(FULL, inc, o);
                if (lane >= o) inc += y;
              }
              for (int q = 0; q < v; ++q) {   // loads first: they may not pass a store
                const int i = cnt + inc - v + q;
                const float cx = cand[(q * 3) * F + f], cy = cand[(q * 3 + 1) * F + f],
                            cz = cand[(q * 3 + 2) * F + f];
                px[i] = cx;
                py[i] = cy;
                pz[i] = cz;
              }
              cnt += __shfl_sync(FULL, inc, 31);
            }
          }
          __syncwarp();
          // Centroid: lane-strided float64 partials and a butterfly (the same
          // value on every lane), rounded once.
          double cxs = 0.0, cys = 0.0, czs = 0.0;
          for (int i = lane; i < cnt; i += 32) {
            cxs += px[i];
            cys += py[i];
            czs += pz[i];
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            cxs += __shfl_xor_sync(FULL, cxs, o);
            cys += __shfl_xor_sync(FULL, cys, o);
            czs += __shfl_xor_sync(FULL, czs, o);
          }
          const float fc = (float)(cnt > 1 ? cnt : 1);
          const float ccx = __double2float_rn(cxs) / fc, ccy = __double2float_rn(cys) / fc,
                      ccz = __double2float_rn(czs) / fc;
          const float ln = fmaxf(sqrtf((nx * nx + ny * ny) + nz * nz), 1e-30f);
          const float ux_n = nx / ln, uy_n = ny / ln, uz_n = nz / ln;
          const float aax = fabsf(ux_n), aay = fabsf(uy_n), aaz = fabsf(uz_n);
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
            const float qx = px[i], qy = py[i], qz = pz[i];
            sx[r] = qx;
            sy[r] = qy;
            sz[r] = qz;
          }
          __syncwarp();
          // Adjacent bitwise duplicates out, truncate to S, the first free face.
          int kept_all = 0;
          for (int base = 0; base < cnt; base += 32) {
            const int r = base + lane;
            const bool keep = r < cnt && !(r > 0 && sx[r] == sx[r - 1] && sy[r] == sy[r - 1] &&
                                           sz[r] == sz[r - 1]);
            kept_all += __popc(__ballot_sync(FULL, keep));
          }
          const int ncap = min(kept_all, S);
          if (lane == 0) *placed = ncap >= 3 && ff < F;
          if (ncap >= 3 && ff < F) {
            float* df = dst + ff * S3;
            const int hw_old = hwd[fi(ff)];
            int at = 0;
            for (int base = 0; base < cnt; base += 32) {
              const int r = base + lane;
              const bool keep = r < cnt && !(r > 0 && sx[r] == sx[r - 1] &&
                                             sy[r] == sy[r - 1] && sz[r] == sz[r - 1]);
              const unsigned m = __ballot_sync(FULL, keep);
              const int pos = at + __popc(m & ((1u << lane) - 1));
              if (keep && pos < S) {
                const float qx = sx[r], qy = sy[r], qz = sz[r];
                df[pos * 3] = qx;
                df[pos * 3 + 1] = qy;
                df[pos * 3 + 2] = qz;
              }
              at += __popc(m);
            }
            for (int s = ncap + lane; s < hw_old; s += 32) {
              df[s * 3] = 0.0f;
              df[s * 3 + 1] = 0.0f;
              df[s * 3 + 2] = 0.0f;
            }
            if (lane == 0) {
              nvd[fi(ff)] = ncap;
              hwd[fi(ff)] = ncap;
              plo[ff * 4 + 0] = nx;
              plo[ff * 4 + 1] = ny;
              plo[ff * 4 + 2] = nz;
              plo[ff * 4 + 3] = d;
            }
          }
        }
      }

      // Commit: fewer than 4 live faces clears the polytope (each face's
      // own thread; the cap's face, counted as free in pass 2, was written
      // before the barrier).
      if (block_vote(words, phase, lv, false, true, 0).x + (any_removed ? *placed : 0) < 4)
        for (int c0 = 0; w + nw * c0 < F; c0 += 32) {
          const int f = w + nw * (c0 + lane);
          if (f < F) nvd[fi(f)] = 0;
        }
      cur ^= 1;
    }
    __syncthreads();

    float* gout = fv_out + (size_t)b * FS3;
    const float* fin = cur ? fv1 : fv0;
    if (SHARED && (reinterpret_cast<uintptr_t>(gout) & 15) == 0) {
      for (int j = 4 * tid; j + 3 < FS3; j += 4 * nt)
        *reinterpret_cast<float4*>(gout + j) = *reinterpret_cast<const float4*>(fin + j);
      for (int j = (FS3 & ~3) + tid; j < FS3; j += nt) gout[j] = fin[j];
    } else {
      for (int j = tid; j < FS3; j += nt) gout[j] = fin[j];
    }
    for (int f = tid; f < F; f += nt) nv_out[(size_t)b * F + f] = (cur ? nv1 : nv0)[fi(f)];
    __syncthreads();                            // the state is read before the next polytope
  }
}

// Dynamic shared memory the kernel is cleared for, per device (a function
// attribute belongs to the current device).
constexpr int MAX_DEVICES = 64;
int smem_set[MAX_DEVICES] = {};
int cta_smem_set[2][MAX_DEVICES] = {};   // clip_cta_kernel<false>, <true>

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

// The CTA variant: one CTA a polytope of 16 warps (32 past F = 512). With
// scratch == nullptr the whole state lies in shared memory
// (surtr_clip_fold_cta_bytes(F, S) must fit a CTA) and the grid is N;
// else the vertex buffers lie in `scratch`, `slots` * cta_vert_words(F, S)
// floats, and `slots` CTAs walk the polytopes (the per-face state,
// surtr_clip_fold_cta_aux_bytes(F), in shared memory).
extern "C" int surtr_clip_fold_cta(const float* fv, const int* nv, const float* pl,
                                   const float* cuts, const unsigned char* cmask, int cs, int ms,
                                   float* ofv, int* onv, float* opl, int N, int F, int S, int K,
                                   float tol, float* scratch, int slots, void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const bool shared = scratch == nullptr;
  if (!shared && slots < 1) return (int)cudaErrorInvalidValue;
  const long long smem = (cta_aux_words(F) + (shared ? cta_vert_words(F, S) : 0)) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int& set = cta_smem_set[shared][dev];
  if (smem > 48 * 1024 && (int)smem > set) {
    const cudaError_t e = cudaFuncSetAttribute(
        shared ? clip_cta_kernel<true> : clip_cta_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    set = (int)smem;
  }
  const int threads = F > 512 ? 1024 : 512;   // 16 warps measured fastest at F = 256
  const int grid = shared ? N : (N < slots ? N : slots);
  if (shared)
    clip_cta_kernel<true><<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(
        fv, nv, pl, cuts, cmask, cs, ms, ofv, onv, opl, N, F, S, K, tol, nullptr);
  else
    clip_cta_kernel<false><<<grid, threads, (size_t)smem, (cudaStream_t)stream>>>(
        fv, nv, pl, cuts, cmask, cs, ms, ofv, onv, opl, N, F, S, K, tol, scratch);
  return (int)cudaGetLastError();
}

// Bytes of one polytope's state in the CTA variant, whole and without its
// vertex buffers (clip_cuda.cta_bytes, cta_aux_bytes mirror them).
extern "C" long long surtr_clip_fold_cta_bytes(int F, int S) {
  return (cta_aux_words(F) + cta_vert_words(F, S)) * 4;
}

extern "C" long long surtr_clip_fold_cta_aux_bytes(int F, int S) {
  (void)S;
  return cta_aux_words(F) * 4;
}
