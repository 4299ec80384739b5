// Pooled triangle-soup clip (kernel B10).
//
// Replaces: surtr_tpu/ops/soup_clip_pallas.py `_soup_kernel` (wrapper
// `soup_clip_pooled_pallas`). Semantics of the plain
// surtr_tpu_torch/ops/soup_clip_cuda.py `soup_clip_pooled_reference`: every
// pooled lane is one triangle with its cell id, turned into a polygon of
// S slots (8 in the warp fold, 3-32 in the group fold, any S >= 3 in the
// general one) and folded by
// each live plane of its cell (Sutherland-Hodgman
// with cyclic-run emission [rotated kept run, exit, enter]; exit and enter
// are sums over the slots in slot order from +0; n_out = min(mcnt + ex +
// en, S); the in-plane drop rule; the multirun guard, counted; n_out < 3
// becomes 0). Masked planes are no-ops; a cell id outside [0, C) reads no
// planes. Cell ids come as int32 or int64.
//
// The in-plane rule's context is per block of BN lanes, as the TPU kernel
// computes it (its grid step is a BN-lane block): for plane k of cell c it
// is true when any valid lane of cell c in the same block has an original
// corner with ((x*nx + y*ny) + z*nz) + d > tol and plane k is live. Blocks
// run in no order here, so a first launch ORs each lane's K-bit mask into a
// zeroed (P/BN, C, ceil(K/32)) table with atomicOr, and a second launch
// folds. One cudaMemsetAsync zeroes the table and the drop counter, which
// the fold's warps add their multirun drops into: three device operations
// a call.
//
// What bounds it on the card: the bytes of the pool, about 150 a lane
// (triangle, id, the 8-slot result), against the fold's float work, about
// 36 operations per slot per live plane of a live lane; the pipeline's
// pools are mostly dead lanes (capacity over live pairs), so bytes bound
// it, at a microsecond or two. What the time is: a live lane's fold, a
// dependent chain through its cell's planes. The first design ran it on
// one thread (~10^4 instructions at K = 32, an 8 x 8 select for the
// rotation). This design gives a lane 8 threads, one a slot (4 lanes a
// warp): each thread computes its slot's distance and cut point; the kept,
// exit, enter and off-plane masks are ballots, the run count and start
// popcounts, the rotated emission one shuffle from slot (a + j) mod nv. The
// exit and enter points are the eight-term sums of the plain version, in
// slot order from +0, by shuffles. A plane that keeps every live corner of
// every lane of the warp is skipped: its step is the identity
// (tests/test_torch_soup_clip.py holds the plain step to that), and most
// of a cell's planes miss a given triangle. A step of the fold is a long
// dependent chain of one warp (a plane load, distances, shuffles, ballots,
// three divisions, the emission); the skip test costs a distance and two
// ballots. A group stages its cell's planes eight at a time in shared
// memory, fetched one chunk ahead (masks and context bits by ballot); the
// warp walks the planes in step and leaves when every lane is done (no
// planes, or emptied at a live plane).
// Measured by tools/time_b10_b12.py on an NVIDIA H100 80GB HBM3 at 700 W,
// the first design in the same call: the two kernels 0.0234-0.0238 ms on
// the sphere's call (32,768 lanes, 4,596 live) against 0.087-0.090, and
// 0.0211-0.0212 ms on the pooled impact's (12,288 lanes) against 0.080;
// 3 device operations a call against 7-8. Built with -fmad=false, so every
// product and sum rounds as in the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int S = 8;
constexpr int THREADS = 128;          // 16 lanes a CTA, 4 a warp
constexpr unsigned FULL = 0xffffffffu;

// The lane's cell id, and whether it lies in [0, C).
__device__ inline bool lane_cell(const void* cell, int ids64, int i, int C, int* c) {
  const long long v = ids64 ? static_cast<const long long*>(cell)[i]
                            : (long long)static_cast<const int*>(cell)[i];
  *c = (int)v;
  return v >= 0 && v < C;
}

// 1. The per-block context: 8 threads a lane, thread s tests the planes
// k = 32w + 8q + s of each context word w.
__global__ void __launch_bounds__(THREADS)
soup_ctx_kernel(const float* __restrict__ tri, const unsigned char* __restrict__ valid,
                const void* __restrict__ cell, int ids64, const float* __restrict__ planes,
                const unsigned char* __restrict__ pmask, unsigned* __restrict__ ctx, int P,
                int C, int K, int BN, int W, float tol) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int i = (int)(t >> 3), s = (int)(t & 7);
  if (i >= P) return;
  int c;
  if (!valid[i] || !lane_cell(cell, ids64, i, C, &c)) return;   // the whole group
  const unsigned gm = 0xffu << (threadIdx.x & 24);
  float v[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) v[j] = tri[(size_t)i * 9 + j];
  unsigned* row = ctx + ((size_t)(i / BN) * C + c) * W;
  for (int w = 0; w < W; ++w) {
    unsigned bits = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = q * 8 + s, k = w * 32 + kk;
      if (k < K && pmask[(size_t)c * K + k]) {
        const float* p = planes + ((size_t)c * K + k) * 4;
        const float nx = p[0], ny = p[1], nz = p[2], d = p[3];
        const float d0 = ((v[0] * nx + v[1] * ny) + v[2] * nz) + d;
        const float d1 = ((v[3] * nx + v[4] * ny) + v[5] * nz) + d;
        const float d2 = ((v[6] * nx + v[7] * ny) + v[8] * nz) + d;
        // amax(d) > tol: a NaN distance makes the max NaN, never beyond.
        const bool nan = isnan(d0) || isnan(d1) || isnan(d2);
        if (!nan && (d0 > tol || d1 > tol || d2 > tol)) bits |= 1u << kk;
      }
    }
    bits |= __shfl_xor_sync(gm, bits, 1, 8);
    bits |= __shfl_xor_sync(gm, bits, 2, 8);
    bits |= __shfl_xor_sync(gm, bits, 4, 8);
    if (s == 0 && bits) atomicOr(row + w, bits);
  }
}

// 2. The fold: 8 threads a lane (thread s holds slot s), 4 lanes a warp,
// the warp's planes in step.
__global__ void __launch_bounds__(THREADS)
soup_fold_kernel(const float* __restrict__ tri, const unsigned char* __restrict__ valid,
                 const void* __restrict__ cell, int ids64, const float* __restrict__ planes,
                 const unsigned char* __restrict__ pmask, const unsigned* __restrict__ ctx,
                 float* __restrict__ poly_out, int* __restrict__ nv_out,
                 unsigned long long* __restrict__ drops, int P, int C, int K, int BN, int W,
                 float tol) {
  __shared__ float4 staged[THREADS];                // a group's 8 planes of the current chunk
  const int lane = threadIdx.x & 31, gb = lane & 24, s = lane & 7;
  const int i = (int)(((long long)blockIdx.x * THREADS + threadIdx.x) >> 3);
  const bool exists = i < P;
  int c = 0;
  const bool inside = exists && lane_cell(cell, ids64, i, C, &c);
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (exists && s < 3) {
    px = tri[(size_t)i * 9 + s * 3];
    py = tri[(size_t)i * 9 + s * 3 + 1];
    pz = tri[(size_t)i * 9 + s * 3 + 2];
  }
  int nv = exists && valid[i] ? 3 : 0;
  int mrun = 0;
  bool done = !inside;
  const unsigned* crow = ctx + ((size_t)(i / BN) * C + c) * W;
  float4* gpl = staged + (threadIdx.x & ~7);
  // Thread s reads plane k0 + s of its lane's cell, its mask and context
  // bit, one chunk ahead of the fold.
  float4 pv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool pv_live = false, pv_rm = false;
  auto fetch = [&](int k0) {
    const int k = k0 + s;
    pv_live = pv_rm = false;
    if (!done && k < K) {
      const float* p = planes + ((size_t)c * K + k) * 4;
      pv = make_float4(p[0], p[1], p[2], p[3]);
      pv_live = pmask[(size_t)c * K + k] != 0;
      pv_rm = (crow[k >> 5] >> (k & 31)) & 1u;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += 8) {
    if (__all_sync(FULL, done)) break;
    const bool live_k = pv_live && !done, rm_k = pv_rm;
    __syncwarp();
    gpl[s] = pv;
    __syncwarp();
    fetch(k0 + 8);
    const unsigned lb = __ballot_sync(FULL, live_k), rb = __ballot_sync(FULL, rm_k);
    const unsigned glive = (lb >> gb) & 0xffu, grm = (rb >> gb) & 0xffu;
    const unsigned wlive = (lb | (lb >> 8) | (lb >> 16) | (lb >> 24)) & 0xffu;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!((wlive >> j) & 1u)) continue;           // no lane of the warp has plane j live
      bool live = !done && ((glive >> j) & 1u);
      if (live && nv == 0) {
        // A live plane folds an empty polygon to all-zero slots, and every
        // later plane keeps them so: the same result without the work.
        px = py = pz = 0.0f;
        done = true;
        live = false;
      }
      if (!__any_sync(FULL, live)) continue;
      const float4 pl = gpl[j];
      const float ds = ((px * pl.x + py * pl.y) + pz * pl.z) + pl.w;
      const bool m = s < nv;
      const bool kept = m && ds <= tol;
      const bool off = m && !(fabsf(ds) <= tol);
      const unsigned bk = (__ballot_sync(FULL, kept) >> gb) & 0xffu;
      const unsigned bo = (__ballot_sync(FULL, off) >> gb) & 0xffu;
      const bool rm = (grm >> j) & 1u;
      // A plane that keeps every corner is the identity (one run from slot
      // 0, no crossing; the slots past nv are +0 already), unless the
      // polygon lies in it and the plane removes material: when that holds
      // for every lane of the warp, the step is skipped.
      const bool same = !live || (bk == (1u << nv) - 1u && !(bo == 0u && nv > 0 && rm));
      if (__all_sync(FULL, same)) continue;
      const int src = gb + (s == nv - 1 ? 0 : ((s + 1) & 7));
      const float vx = __shfl_sync(FULL, px, src);
      const float vy = __shfl_sync(FULL, py, src);
      const float vz = __shfl_sync(FULL, pz, src);
      const float dn = ((vx * pl.x + vy * pl.y) + vz * pl.z) + pl.w;   // ds of slot src
      const float denom = dn - ds;
      const float safe = fabsf(denom) > 1e-30f ? denom : 1.0f;
      const float cx = (px * dn - vx * ds) / safe, cy = (py * dn - vy * ds) / safe,
                  cz = (pz * dn - vz * ds) / safe;
      const bool cex = m && ds < -tol && dn > tol;
      const bool cen = m && ds > tol && dn < -tol;
      const unsigned bx = (__ballot_sync(FULL, cex) >> gb) & 0xffu;
      const unsigned bn = (__ballot_sync(FULL, cen) >> gb) & 0xffu;
      const int ex = bx != 0u, en = bn != 0u;
      const int mcnt = __popc(bk);
      const unsigned klast = nv > 0 ? (bk >> (nv - 1)) & 1u : 0u;
      const unsigned st = bk & ~(((bk << 1) | klast) & 0xffu);   // run starts
      const int nstarts = __popc(st);
      const int a = __popc(st & 0xAAu) + 2 * __popc(st & 0xCCu) + 4 * __popc(st & 0xF0u);

      // Exit and enter points: sums over the slots in slot order from +0.
      const float fe = cex ? 1.0f : 0.0f, fn = cen ? 1.0f : 0.0f;
      const float tx = fe * cx, ty = fe * cy, tz = fe * cz;
      const float ux = fn * cx, uy = fn * cy, uz = fn * cz;
      float exx = 0.0f, exy = 0.0f, exz = 0.0f, enx = 0.0f, eny = 0.0f, enz = 0.0f;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        exx = exx + __shfl_sync(FULL, tx, gb + q);
        exy = exy + __shfl_sync(FULL, ty, gb + q);
        exz = exz + __shfl_sync(FULL, tz, gb + q);
        enx = enx + __shfl_sync(FULL, ux, gb + q);
        eny = eny + __shfl_sync(FULL, uy, gb + q);
        enz = enz + __shfl_sync(FULL, uz, gb + q);
      }

      // Emit [rotated kept run, exit, enter]: slot s takes poly[(a + s) mod nv].
      const int nvc = nv > 0 ? nv : 1;
      const int rs = gb + (a + s) % nvc;
      const float rx = __shfl_sync(FULL, px, rs);
      const float ry = __shfl_sync(FULL, py, rs);
      const float rz = __shfl_sync(FULL, pz, rs);
      if (live) {
        if (s < mcnt) {
          px = rx; py = ry; pz = rz;
        } else if (s == mcnt && ex) {
          px = exx; py = exy; pz = exz;
        } else if (s == mcnt + ex && en) {
          px = enx; py = eny; pz = enz;
        } else {
          px = py = pz = 0.0f;
        }
        int n_out = min(mcnt + ex + en, S);
        if (bo == 0u && nv > 0 && rm) n_out = 0;   // in-plane, material removed
        const bool multirun = nstarts > 1;
        if (multirun) n_out = 0;
        if (n_out < 3) n_out = 0;
        nv = n_out;
        mrun += multirun;
      }
    }
  }
  if (exists) {
    float* o = poly_out + ((size_t)i * S + s) * 3;
    o[0] = px;
    o[1] = py;
    o[2] = pz;
    if (s == 0) nv_out[i] = nv;
  }
  const unsigned md = __reduce_add_sync(FULL, exists && s == 0 ? (unsigned)mrun : 0u);
  if (lane == 0 && md) atomicAdd(drops, (unsigned long long)md);
}

// 2'. The group variant's fold, for a polygon of 3 <= S <= 32 slots (S != 8
// on the wrapper's choice): soup_fold_kernel's design with a group of G
// threads a lane, G the least power of two >= S (4, 8, 16 or 32), 32 / G
// lanes a warp; thread s holds slot s, the threads past S hold none. The
// masks are ballots masked to the group; the run start is the sum of the
// start bits' positions by popcounts; the emission one shuffle from slot
// (a + s) mod nv, by a conditional subtraction (a + s < 2 nv on a single
// run; a modulo only past it). The exit and enter points are the S-term
// sums of the plain version in slot order from +0; where every group of
// the warp has at most one exit and one enter slot and finite cut points
// in all S slots, each sum is +0 plus its one crossing's cut (every other
// term is a zero, and a zero never turns a sum from +0 to anything else),
// one shuffle each, else all S terms are shuffled in. A group stages its
// cell's planes G at a time, one chunk ahead, and the warp skips a plane
// that keeps every live corner of its lanes, as soup_fold_kernel does.
// Measured by tools/time_b10_b12.py --limits on an NVIDIA H100 80GB HBM3 at
// 700 W, the general fold in the same call: 0.0199 ms on the sphere's call
// at S = 16 against 0.49-0.51, 0.0297 at S = 32 against 0.99.
template <int G>
__global__ void __launch_bounds__(THREADS)
soup_fold_group_kernel(const float* __restrict__ tri, const unsigned char* __restrict__ valid,
                       const void* __restrict__ cell, int ids64, const float* __restrict__ planes,
                       const unsigned char* __restrict__ pmask, const unsigned* __restrict__ ctx,
                       float* __restrict__ poly_out, int* __restrict__ nv_out,
                       unsigned long long* __restrict__ drops, int P, int C, int K, int BN, int W,
                       int S, float tol) {
  constexpr unsigned GM = G == 32 ? FULL : (1u << G) - 1u;   // a group's bits
  __shared__ float4 staged[THREADS];                // a group's G planes of the current chunk
  const int lane = threadIdx.x & 31, gb = lane & (32 - G), s = lane & (G - 1);
  const int i = (int)(((long long)blockIdx.x * THREADS + threadIdx.x) / G);
  const bool exists = i < P;
  int c = 0;
  const bool inside = exists && lane_cell(cell, ids64, i, C, &c);
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (exists && s < 3) {
    px = tri[(size_t)i * 9 + s * 3];
    py = tri[(size_t)i * 9 + s * 3 + 1];
    pz = tri[(size_t)i * 9 + s * 3 + 2];
  }
  int nv = exists && valid[i] ? 3 : 0;
  int mrun = 0;
  bool done = !inside;
  const unsigned* crow = ctx + ((size_t)(i / BN) * C + c) * W;
  float4* gpl = staged + (threadIdx.x & ~(G - 1));
  float4 pv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool pv_live = false, pv_rm = false;
  auto fetch = [&](int k0) {
    const int k = k0 + s;
    pv_live = pv_rm = false;
    if (!done && k < K) {
      const float* p = planes + ((size_t)c * K + k) * 4;
      pv = make_float4(p[0], p[1], p[2], p[3]);
      pv_live = pmask[(size_t)c * K + k] != 0;
      pv_rm = (crow[k >> 5] >> (k & 31)) & 1u;
    }
  };
  auto grp = [&](unsigned b) { return (b >> gb) & GM; };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += G) {
    if (__all_sync(FULL, done)) break;
    const bool live_k = pv_live && !done, rm_k = pv_rm;
    __syncwarp();
    gpl[s] = pv;
    __syncwarp();
    fetch(k0 + G);
    const unsigned lb = __ballot_sync(FULL, live_k), rb = __ballot_sync(FULL, rm_k);
    const unsigned glive = grp(lb), grm = grp(rb);
    unsigned wl = lb;
#pragma unroll
    for (int sh = 16; sh >= G; sh >>= 1) wl |= wl >> sh;
    const unsigned wlive = wl & GM;
#pragma unroll 1
    for (int j = 0; j < G; ++j) {
      if (!((wlive >> j) & 1u)) continue;           // no lane of the warp has plane j live
      bool live = !done && ((glive >> j) & 1u);
      if (live && nv == 0) {
        px = py = pz = 0.0f;
        done = true;
        live = false;
      }
      if (!__any_sync(FULL, live)) continue;
      const float4 pl = gpl[j];
      const float ds = ((px * pl.x + py * pl.y) + pz * pl.z) + pl.w;
      const bool m = s < nv;
      const bool kept = m && ds <= tol;
      const bool off = m && !(fabsf(ds) <= tol);
      const unsigned bk = grp(__ballot_sync(FULL, kept));
      const unsigned bo = grp(__ballot_sync(FULL, off));
      const bool rm = (grm >> j) & 1u;
      const unsigned all = nv >= 32 ? FULL : (1u << nv) - 1u;
      const bool same = !live || (bk == all && !(bo == 0u && nv > 0 && rm));
      if (__all_sync(FULL, same)) continue;
      // Slot s's successor: slot 0 after the last live slot and after slot
      // S - 1 (the plain version's roll over S slots); slot 0 for the
      // threads past S.
      const int src = gb + ((s == nv - 1 || s + 1 >= S) ? 0 : s + 1);
      const float vx = __shfl_sync(FULL, px, src);
      const float vy = __shfl_sync(FULL, py, src);
      const float vz = __shfl_sync(FULL, pz, src);
      const float dn = ((vx * pl.x + vy * pl.y) + vz * pl.z) + pl.w;
      const float denom = dn - ds;
      const float safe = fabsf(denom) > 1e-30f ? denom : 1.0f;
      const float cx = (px * dn - vx * ds) / safe, cy = (py * dn - vy * ds) / safe,
                  cz = (pz * dn - vz * ds) / safe;
      const bool cex = m && ds < -tol && dn > tol;
      const bool cen = m && ds > tol && dn < -tol;
      const unsigned bx = grp(__ballot_sync(FULL, cex));
      const unsigned bn = grp(__ballot_sync(FULL, cen));
      const int ex = bx != 0u, en = bn != 0u;
      const int mcnt = __popc(bk);
      const unsigned klast = nv > 0 ? (bk >> (nv - 1)) & 1u : 0u;
      const unsigned st = bk & ~(((bk << 1) | klast) & GM);   // run starts
      const int nstarts = __popc(st);
      const int a = __popc(st & 0xAAAAAAAAu) + 2 * __popc(st & 0xCCCCCCCCu)
                  + 4 * __popc(st & 0xF0F0F0F0u) + 8 * __popc(st & 0xFF00FF00u)
                  + 16 * __popc(st & 0xFFFF0000u);

      // Exit and enter points: sums over the S slots in slot order from +0.
      const bool fin = s >= S || (isfinite(cx) && isfinite(cy) && isfinite(cz));
      const unsigned nonfin = grp(__ballot_sync(FULL, !fin));
      const bool one = nonfin == 0u && __popc(bx) <= 1 && __popc(bn) <= 1;
      float exx = 0.0f, exy = 0.0f, exz = 0.0f, enx = 0.0f, eny = 0.0f, enz = 0.0f;
      if (__all_sync(FULL, one)) {
        const int qx = gb + (bx ? __ffs(bx) - 1 : 0), qn = gb + (bn ? __ffs(bn) - 1 : 0);
        const float ax = __shfl_sync(FULL, cx, qx), ay = __shfl_sync(FULL, cy, qx),
                    az = __shfl_sync(FULL, cz, qx);
        const float nx = __shfl_sync(FULL, cx, qn), ny = __shfl_sync(FULL, cy, qn),
                    nz = __shfl_sync(FULL, cz, qn);
        if (ex) {
          exx = exx + ax; exy = exy + ay; exz = exz + az;
        }
        if (en) {
          enx = enx + nx; eny = eny + ny; enz = enz + nz;
        }
      } else {
        const float fe = cex ? 1.0f : 0.0f, fn = cen ? 1.0f : 0.0f;
        const float tx = fe * cx, ty = fe * cy, tz = fe * cz;
        const float ux = fn * cx, uy = fn * cy, uz = fn * cz;
        for (int q = 0; q < S; ++q) {
          exx = exx + __shfl_sync(FULL, tx, gb + q);
          exy = exy + __shfl_sync(FULL, ty, gb + q);
          exz = exz + __shfl_sync(FULL, tz, gb + q);
          enx = enx + __shfl_sync(FULL, ux, gb + q);
          eny = eny + __shfl_sync(FULL, uy, gb + q);
          enz = enz + __shfl_sync(FULL, uz, gb + q);
        }
      }

      // Emit [rotated kept run, exit, enter]: slot s takes poly[(a + s) mod nv].
      const int nvc = nv > 0 ? nv : 1;
      int t = a + s;
      if (t >= nvc) t -= nvc;
      if (t >= nvc) t %= nvc;                        // several runs: a may pass nv
      const int rs = gb + t;
      const float rx = __shfl_sync(FULL, px, rs);
      const float ry = __shfl_sync(FULL, py, rs);
      const float rz = __shfl_sync(FULL, pz, rs);
      if (live) {
        if (s < mcnt) {
          px = rx; py = ry; pz = rz;
        } else if (s == mcnt && ex) {
          px = exx; py = exy; pz = exz;
        } else if (s == mcnt + ex && en) {
          px = enx; py = eny; pz = enz;
        } else {
          px = py = pz = 0.0f;
        }
        int n_out = min(mcnt + ex + en, S);
        if (bo == 0u && nv > 0 && rm) n_out = 0;   // in-plane, material removed
        const bool multirun = nstarts > 1;
        if (multirun) n_out = 0;
        if (n_out < 3) n_out = 0;
        nv = n_out;
        mrun += multirun;
      }
    }
  }
  if (exists && s < S) {
    float* o = poly_out + ((size_t)i * S + s) * 3;
    o[0] = px;
    o[1] = py;
    o[2] = pz;
    if (s == 0) nv_out[i] = nv;
  }
  const unsigned md = __reduce_add_sync(FULL, exists && s == 0 ? (unsigned)mrun : 0u);
  if (lane == 0 && md) atomicAdd(drops, (unsigned long long)md);
}

// 2''. The general variant's fold, for a polygon of S > 32 slots: one
// thread a lane, the plain step written out slot by slot (distances, cut
// points, the exit and enter sums in slot order from +0, the run count and
// start, the rotated emission), the polygon ping-ponging between its rows
// of poly_out and of `tmp` (both (P, S, 3)). Any S >= 3; the wrapper takes
// it past S = 32 only, where a lane's slots pass a warp.
__device__ __forceinline__ float plane_dist(const float* v, float4 pl) {
  return ((v[0] * pl.x + v[1] * pl.y) + v[2] * pl.z) + pl.w;
}

__global__ void __launch_bounds__(THREADS)
soup_fold_general_kernel(const float* __restrict__ tri, const unsigned char* __restrict__ valid,
                         const void* __restrict__ cell, int ids64,
                         const float* __restrict__ planes, const unsigned char* __restrict__ pmask,
                         const unsigned* __restrict__ ctx, float* __restrict__ poly_out,
                         int* __restrict__ nv_out, unsigned long long* __restrict__ drops,
                         float* __restrict__ tmp, int P, int C, int K, int BN, int W, int S,
                         float tol) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= P) return;
  int c = 0;
  const bool inside = lane_cell(cell, ids64, i, C, &c);
  float* cur = poly_out + (size_t)i * S * 3;
  float* nxt = tmp + (size_t)i * S * 3;
  for (int q = 0; q < 3 * S; ++q) cur[q] = q < 9 ? tri[(size_t)i * 9 + q] : 0.0f;
  int nv = valid[i] ? 3 : 0;
  unsigned long long mrun = 0;
  const unsigned* crow = ctx + ((size_t)(i / BN) * C + c) * W;
  for (int k = 0; inside && k < K; ++k) {
    if (!pmask[(size_t)c * K + k]) continue;        // masked plane: no-op
    const float* pp = planes + ((size_t)c * K + k) * 4;
    const float4 pl = make_float4(pp[0], pp[1], pp[2], pp[3]);
    const bool rm = (crow[k >> 5] >> (k & 31)) & 1u;
    // Pass 1: the kept run, the crossings and their sums, the in-plane test.
    int mcnt = 0, nstarts = 0, a = 0;
    bool ex = false, en = false, inplane = true;
    float exx = 0.0f, exy = 0.0f, exz = 0.0f, enx = 0.0f, eny = 0.0f, enz = 0.0f;
    const bool klast = nv > 0 && nv <= S && plane_dist(cur + 3 * (nv - 1), pl) <= tol;
    bool kprev = klast;
    for (int q = 0; q < S; ++q) {
      const float* v = cur + 3 * q;
      const float* w = (q == nv - 1) ? cur : cur + 3 * ((q + 1) % S);
      const float ds = plane_dist(v, pl), dn = plane_dist(w, pl);
      const bool m = q < nv;
      const bool kept = m && ds <= tol;
      if (m && !(fabsf(ds) <= tol)) inplane = false;
      const float denom = dn - ds;
      const float safe = fabsf(denom) > 1e-30f ? denom : 1.0f;
      const float cx = (v[0] * dn - w[0] * ds) / safe, cy = (v[1] * dn - w[1] * ds) / safe,
                  cz = (v[2] * dn - w[2] * ds) / safe;
      const bool cex = m && ds < -tol && dn > tol;
      const bool cen = m && ds > tol && dn < -tol;
      const float fe = cex ? 1.0f : 0.0f, fn = cen ? 1.0f : 0.0f;
      exx = exx + fe * cx; exy = exy + fe * cy; exz = exz + fe * cz;
      enx = enx + fn * cx; eny = eny + fn * cy; enz = enz + fn * cz;
      ex |= cex;
      en |= cen;
      if (kept && !(q == 0 ? klast : kprev)) {
        ++nstarts;
        a += q;
      }
      kprev = kept;
      mcnt += kept;
    }
    // Pass 2: emit [rotated kept run, exit, enter], zeros beyond.
    const int nvc = nv > 0 ? nv : 1;
    for (int q = 0; q < S; ++q) {
      float x = 0.0f, y = 0.0f, z = 0.0f;
      if (q < mcnt) {
        const float* r = cur + 3 * ((a + q) % nvc);
        x = r[0]; y = r[1]; z = r[2];
      } else if (q == mcnt && ex) {
        x = exx; y = exy; z = exz;
      } else if (q == mcnt + (int)ex && en) {
        x = enx; y = eny; z = enz;
      }
      nxt[3 * q] = x; nxt[3 * q + 1] = y; nxt[3 * q + 2] = z;
    }
    int n_out = min(mcnt + (int)ex + (int)en, S);
    if (inplane && nv > 0 && rm) n_out = 0;        // in-plane, material removed
    if (nstarts > 1) {
      n_out = 0;                                   // multirun: dropped, counted
      ++mrun;
    }
    nv = n_out >= 3 ? n_out : 0;
    float* t = cur; cur = nxt; nxt = t;
  }
  float* o = poly_out + (size_t)i * S * 3;
  if (cur != o)
    for (int q = 0; q < 3 * S; ++q) o[q] = cur[q];
  nv_out[i] = nv;
  if (mrun) atomicAdd(drops, mrun);
}

}  // namespace

// scratch: 8 bytes of drop counter, then ceil(P / BN) * max(C, 1) * W
// context words; zeroed here. Launches the context pass then the fold on
// `stream`; returns the first CUDA error. variant: 0 the warp fold (S = 8),
// 1 the group fold (3 <= S <= 32), 2 the general fold (any S >= 3, with
// `tmp` a (P, S, 3) float scratch).
extern "C" int surtr_soup_clip(const float* tri, const unsigned char* valid, const void* cell,
                               int ids64, const float* planes, const unsigned char* pmask,
                               unsigned long long* scratch, float* poly, int* nv, int P, int C,
                               int K, int BN, int W, float tol, int slots, int variant,
                               float* tmp, void* stream) {
  if (P <= 0) return 0;
  if (BN <= 0 || W < (K + 31) / 32 || W < 1) return (int)cudaErrorInvalidValue;
  if ((variant == 0 && slots != S) || (variant == 1 && (slots < 3 || slots > 32))
      || (variant == 2 && (slots < 3 || tmp == nullptr)) || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t words = (size_t)((P + BN - 1) / BN) * (size_t)(C > 0 ? C : 1) * W;
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) + words * 4, st);
  if (e != cudaSuccess) return (int)e;
  unsigned* ctx = reinterpret_cast<unsigned*>(scratch + 1);
  const unsigned grid = (unsigned)(((long long)P * S + THREADS - 1) / THREADS);
  soup_ctx_kernel<<<grid, THREADS, 0, st>>>(tri, valid, cell, ids64, planes, pmask, ctx, P, C,
                                            K, BN, W, tol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (variant == 2) {
    soup_fold_general_kernel<<<(unsigned)((P + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        tri, valid, cell, ids64, planes, pmask, ctx, poly, nv, scratch, tmp, P, C, K, BN, W,
        slots, tol);
    return (int)cudaGetLastError();
  }
  if (variant == 1) {
    const int G = slots <= 4 ? 4 : slots <= 8 ? 8 : slots <= 16 ? 16 : 32;
    const unsigned g = (unsigned)(((long long)P * G + THREADS - 1) / THREADS);
#define SURTR_GROUP_ARGS tri, valid, cell, ids64, planes, pmask, ctx, poly, nv, scratch, P, C, K, \
                         BN, W, slots, tol
    if (G == 4) soup_fold_group_kernel<4><<<g, THREADS, 0, st>>>(SURTR_GROUP_ARGS);
    else if (G == 8) soup_fold_group_kernel<8><<<g, THREADS, 0, st>>>(SURTR_GROUP_ARGS);
    else if (G == 16) soup_fold_group_kernel<16><<<g, THREADS, 0, st>>>(SURTR_GROUP_ARGS);
    else soup_fold_group_kernel<32><<<g, THREADS, 0, st>>>(SURTR_GROUP_ARGS);
#undef SURTR_GROUP_ARGS
    return (int)cudaGetLastError();
  }
  soup_fold_kernel<<<grid, THREADS, 0, st>>>(tri, valid, cell, ids64, planes, pmask, ctx, poly,
                                             nv, scratch, P, C, K, BN, W, tol);
  return (int)cudaGetLastError();
}
