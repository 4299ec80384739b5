// Pair narrowphase: SAT + containment manifold (kernel B7).
//
// Replaces: surtr_tpu/physics/narrowphase_pallas.py `_narrow_kernel`
// (wrapper `narrowphase_raw_pallas`). Semantics of the plain version in
// surtr_tpu_torch/physics/narrowphase_cuda.py `narrowphase_reference`: for
// the pair (piece i, its k-th broadphase candidate j), the penetration along
// the 13 DOP axes (interval overlap), j's faces (i's corners against j's
// planes), i's faces (j's corners against i's planes) and the Ne x Ne edge
// cross axes; the least penetration, first of ties in that order, gives the
// normal (j -> i) and depth. Then up to M contact points, deepest first and
// first of ties, from i's corners inside j and j's corners inside i (each
// moved half its depth along the normal), with the support-point fallback
// when none is contained, and each point's feature id. One output record of
// 5 + 6M floats per pair: nx ny nz depth hit, then per point
// val hit px py pz fid.
//
// What bounds it on the card: bytes, barely. Per pair it reads two packed
// rows (2 x 440 B at Vh = 8, F = 8, Ne = 3) and writes 116 B, and does
// ~2,600 flops (the 2 x Vh x F plane distances dominate). At 80,000 pairs:
// ~14 MB unique traffic and ~0.2 GFLOP; in practice the instructions
// bound it (a lane's share of the plane distances, folds and reductions).
// Design: a block of 128 threads takes a run of consecutive pairs (a tile
// of pieces). It copies the pieces' own rows (one contiguous span) and the
// partner row of each pair (a warp a row) into shared memory, 16 bytes a
// lane over each row's 16-byte aligned cover, so a row costs its own bytes
// and not a sector per field, then computes from there. (cp.async copies
// of the same spans measured slower on the H100 than these loads.) A pair
// gets a group of G = Vh / 4 lanes (2 at the lattice's Vh = 8, 16 at the
// frame's Vh = 64, whose 2,048 pairs then fill 256 blocks; 1 and 4 lanes
// at Vh = 8, 8 and 32 at Vh = 64 measured slower), and each lane
// holds four corners of each hull in registers, so no thread holds arrays
// of length Vh and a plane or an edge axis is read once a lane, not once
// a corner:
// - the 13 DOP axes go round the group's lanes; then every lane walks the
//   face and edge axes in family order (j's faces, i's faces, the Ne^2
//   edge crosses), folding its corners' distances to a face (and their
//   containment maxima over the other hull's planes) or its corners'
//   projections on an edge axis, and a shuffle reduction across the group
//   completes each fold (fminf / fmaxf order -0 below +0, so any tree gives
//   the bits of a fold in corner order); the lanes take turns normalizing
//   the edge axes (one sqrt and one divide each) and pass them round;
// - each lane keeps its best (penetration, family index); the group's
//   least is a shuffle reduction on that key, first of ties;
// - si_min / sj_max, each of the M manifold picks and the fallback's
//   support corners are shuffle reductions ((value, index) keys, lowest
//   index on ties, and the plain walk's NaN rule);
// - the block's records are assembled in shared memory and written as one
//   contiguous span.
// Built with -fmad=false, every value rounds as the plain version's.
// Shapes this kernel does not take (another Vh, records wider than a row)
// go to the group variant below, a group of lanes a pair with each
// manifold candidate scored once, and only rows past a block's shared
// memory to the general variant, a thread a pair.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.4e38f;
constexpr float HALF_BIG = 1.7e38f;  // BIG / 2, exact in binary
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_IDX = 0x7fffffff;

// Floats a staged partner row takes: the 16-byte aligned cover of any row
// of D floats.
__host__ __device__ __forceinline__ int row_slot(int D) { return ((D + 6 + 3) / 4) * 4; }

// (v, i) takes (x, j) when x is larger (largest=true) or smaller, or equal
// with a lower index.
template <bool LARGEST>
__device__ __forceinline__ bool wins(float x, int j, float v, int i) {
  return (LARGEST ? x > v : x < v) || (x == v && j < i);
}

template <int G, bool LARGEST>
__device__ __forceinline__ void group_pick(float& v, int& i) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (wins<LARGEST>(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

template <int G>
__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ int group_min_int(int v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// First-of-ties argmax as the sequential walk `if (x > best) take` from the
// first candidate: the first candidate when it is NaN, else the first
// maximum among the non-NaN ones. Each lane passes its best non-NaN
// (value, index); `first` is the lowest candidate index.
template <int G>
__device__ __forceinline__ int seq_argmax(float lv, int li, int first, bool first_nan) {
  group_pick<G, true>(lv, li);
  return first_nan ? first : li;
}

template <int VH, int G>
__global__ void __launch_bounds__(THREADS)
narrow_kernel(const float* __restrict__ packed, const int* __restrict__ pidx,
              const uint8_t* __restrict__ pok, const float* __restrict__ dop, int Np, int K,
              int F, int NE, int M, float slop, int own_cap, float* __restrict__ out) {
  constexpr int PB = THREADS / G;      // pairs a block
  constexpr int CPL = VH / G;          // corners of each hull a lane holds
  extern __shared__ float4 sm4[];
  __shared__ float dop_s[39];
  float* sm = reinterpret_cast<float*>(sm4);
  const int D = 4 * VH + 5 * F + 26 + 4 * NE;
  const int SLOT = row_slot(D);
  const int R = 5 + 6 * M;
  float* own = sm;                     // the block's own rows, a 16-byte aligned span
  float* part = own + own_cap;         // PB partner rows, SLOT floats each; then records
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int P = Np * K;
  const int p0 = blockIdx.x * PB;
  const int npairs = min(PB, P - p0);

  // --- stage the own rows (one span) and each pair's partner row (a warp
  // a row), 16 bytes a lane ---
  const int i_lo = p0 / K, i_hi = (p0 + npairs - 1) / K;
  const long long os4 = ((long long)i_lo * D) >> 2;
  const int on4 = (int)((((long long)(i_hi + 1) * D + 3) >> 2) - os4);
  const float4* src = reinterpret_cast<const float4*>(packed);
  for (int v = tid; v < on4; v += THREADS) reinterpret_cast<float4*>(own)[v] = src[os4 + v];
  for (int r = warp; r < npairs; r += THREADS / 32) {
    int j = pidx[p0 + r];
    j = j < 0 ? 0 : (j >= Np ? Np - 1 : j);
    const long long js4 = ((long long)j * D) >> 2;
    const int jn4 = (int)((((long long)(j + 1) * D + 3) >> 2) - js4);
    float4* dst = reinterpret_cast<float4*>(part + r * SLOT);
    for (int v = wl; v < jn4; v += 32) dst[v] = src[js4 + v];
  }
  if (tid < 39) dop_s[tid] = dop[tid];
  __syncthreads();

  // --- one group of G lanes a pair ---
  const int q = tid / G, g = tid - q * G;
  const int glane = wl - g;            // the group's first lane in the warp
  const int qe = q < npairs ? q : 0;   // lanes past the last pair shadow pair 0
  const int p = p0 + qe;
  const int i = p / K;
  int j = pidx[p];
  j = j < 0 ? 0 : (j >= Np ? Np - 1 : j);
  const float* I = own + (int)((long long)i * D - 4 * os4);
  const float* J = part + qe * SLOT + (int)((long long)j * D - 4 * ((((long long)j * D) >> 2)));
  const int PN = 4 * VH, PD = PN + 3 * F, PM = PN + 4 * F;
  const int LOD = PN + 5 * F, HID = LOD + 13, EX = HID + 13, EM = EX + 3 * NE;

  // This lane's corners v = g + G·r of both hulls, in registers.
  float xi[CPL], yi[CPL], zi[CPL], xj[CPL], yj[CPL], zj[CPL], ins_j[CPL], ins_i[CPL];
  bool mi[CPL], mj[CPL];
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    const int v = g + G * r;
    xi[r] = I[v]; yi[r] = I[VH + v]; zi[r] = I[2 * VH + v]; mi[r] = I[3 * VH + v] > 0.5f;
    xj[r] = J[v]; yj[r] = J[VH + v]; zj[r] = J[2 * VH + v]; mj[r] = J[3 * VH + v] > 0.5f;
    ins_j[r] = -BIG; ins_i[r] = -BIG;
  }

  // Least penetration over the axis candidates in family order. A masked
  // axis counts BIG, or NaN when its penetration is not finite (an edge axis
  // against a piece with no live corner); a NaN axis leaves the pair's depth
  // NaN and its normal 0 (the JAX kernel's pen·mask + (1 - mask)·BIG, min
  // and one-hot pick). The DOP axes go round the group's lanes; every lane
  // follows the face and edge axes, whose folds over the corners end in a
  // group reduction.
  float best = INFINITY, bnx = 0.f, bny = 0.f, bnz = 0.f;
  int bidx = NO_IDX;
  bool undefined = false;
  auto axis = [&](int t, bool live, float pen, float dx, float dy, float dz) {
    if (!live) pen = isfinite(pen) ? BIG : NAN;
    if (isnan(pen)) {
      undefined = true;
    } else if (bidx == NO_IDX || pen < best) {
      best = pen; bidx = t; bnx = dx; bny = dy; bnz = dz;
    }
  };
  // (1) 26-DOP interval axes.
  for (int t = g; t < 13; t += G) {
    const float ilo = I[LOD + t], ihi = I[HID + t], jlo = J[LOD + t], jhi = J[HID + t];
    const float s = (ihi + ilo) < (jhi + jlo) ? -1.0f : 1.0f;
    axis(t, true, fminf(ihi, jhi) - fmaxf(ilo, jlo),
         s * dop_s[t * 3 + 0], s * dop_s[t * 3 + 1], s * dop_s[t * 3 + 2]);
  }
  // (2) i's corners against j's planes, with their containment in j; (3)
  // j's corners against i's planes.
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const float px = J[PN + f], py = J[PN + F + f], pz = J[PN + 2 * F + f], pd = J[PD + f];
    const bool live = J[PM + f] > 0.5f;
    float mn = BIG;
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      const float dist = ((xi[r] * px + yi[r] * py) + zi[r] * pz) + pd;
      if (mi[r]) mn = fminf(mn, dist);
      if (live) ins_j[r] = fmaxf(ins_j[r], dist);
    }
    axis(13 + f, live, -group_min<G>(mn), px, py, pz);
  }
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const float px = I[PN + f], py = I[PN + F + f], pz = I[PN + 2 * F + f], pd = I[PD + f];
    const bool live = I[PM + f] > 0.5f;
    float mn = BIG;
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      const float dist = ((xj[r] * px + yj[r] * py) + zj[r] * pz) + pd;
      if (mj[r]) mn = fminf(mn, dist);
      if (live) ins_i[r] = fmaxf(ins_i[r], dist);
    }
    axis(13 + F + f, live, -group_min<G>(mn), -px, -py, -pz);
  }
  // (4) edge x edge cross axes, i's edge major. The group's lanes take
  // turns normalizing an axis (one sqrt and one divide each) and pass it
  // round by shuffles.
  const int NE2 = NE * NE;
  for (int e0 = 0; e0 < NE2; e0 += G) {
    float cx = 0.f, cy = 0.f, cz = 0.f;
    bool live = false;
    if (e0 + g < NE2) {
      const int a = (e0 + g) / NE, b = (e0 + g) - a * NE;
      const float ax = I[EX + a], ay = I[EX + NE + a], az = I[EX + 2 * NE + a];
      const float bx = J[EX + b], by = J[EX + NE + b], bz = J[EX + 2 * NE + b];
      cx = ay * bz - az * by;
      cy = az * bx - ax * bz;
      cz = ax * by - ay * bx;
      const float nl = sqrtf((cx * cx + cy * cy) + cz * cz);
      const float inv = 1.0f / fmaxf(nl, 1e-30f);
      cx = cx * inv; cy = cy * inv; cz = cz * inv;
      live = (I[EM + a] > 0.5f) && (J[EM + b] > 0.5f) && (nl > 1e-6f);
    }
    const int n = min(G, NE2 - e0);
    for (int k = 0; k < n; ++k) {
      const float ux = __shfl_sync(FULL, cx, glane + k);
      const float uy = __shfl_sync(FULL, cy, glane + k);
      const float uz = __shfl_sync(FULL, cz, glane + k);
      const bool ul = __shfl_sync(FULL, (int)live, glane + k) != 0;
      float ilo = BIG, ihi = -BIG, jlo = BIG, jhi = -BIG;
#pragma unroll
      for (int r = 0; r < CPL; ++r) {
        const float ti = (xi[r] * ux + yi[r] * uy) + zi[r] * uz;
        const float tj = (xj[r] * ux + yj[r] * uy) + zj[r] * uz;
        if (mi[r]) { ilo = fminf(ilo, ti); ihi = fmaxf(ihi, ti); }
        if (mj[r]) { jlo = fminf(jlo, tj); jhi = fmaxf(jhi, tj); }
      }
      ilo = group_min<G>(ilo); ihi = group_max<G>(ihi);
      jlo = group_min<G>(jlo); jhi = group_max<G>(jhi);
      const float s = (ihi + ilo) < (jhi + jlo) ? -1.0f : 1.0f;
      axis(13 + 2 * F + e0 + k, ul, fminf(ihi, jhi) - fmaxf(ilo, jlo), ux * s, uy * s, uz * s);
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oi = __shfl_xor_sync(FULL, bidx, o);
    const float ox = __shfl_xor_sync(FULL, bnx, o);
    const float oy = __shfl_xor_sync(FULL, bny, o);
    const float oz = __shfl_xor_sync(FULL, bnz, o);
    undefined |= __shfl_xor_sync(FULL, (int)undefined, o) != 0;
    if (wins<false>(ob, oi, best, bidx)) { best = ob; bidx = oi; bnx = ox; bny = oy; bnz = oz; }
  }
  float depth = best, nx = bnx, ny = bny, nz = bnz;
  if (undefined) { depth = NAN; nx = 0.f; ny = 0.f; nz = 0.f; }
  const bool hit = (pok[p] != 0) && (depth > -slop) && (depth < HALF_BIG);

  // --- containment manifold over this lane's corners ---
  float si[CPL], sj[CPL], sc[2 * CPL];
  float si_min = BIG, sj_max = -BIG;
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    si[r] = (xi[r] * nx + yi[r] * ny) + zi[r] * nz;
    sj[r] = (xj[r] * nx + yj[r] * ny) + zj[r] * nz;
    if (mi[r]) si_min = fminf(si_min, si[r]);
    if (mj[r]) sj_max = fmaxf(sj_max, sj[r]);
  }
  si_min = group_min<G>(si_min);
  sj_max = group_max<G>(sj_max);
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    sc[r] = (ins_j[r] <= slop && mi[r]) ? sj_max - si[r] : -BIG;
    sc[CPL + r] = (ins_i[r] <= slop && mj[r]) ? sj[r] - si_min : -BIG;
  }
  // Each corner's contact point: moved half its depth along the normal.
  float cxs[2 * CPL], cys[2 * CPL], czs[2 * CPL];
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    const float hi = (sj_max - si[r]) * 0.5f, hj = (sj[r] - si_min) * 0.5f;
    cxs[r] = xi[r] + nx * hi; cys[r] = yi[r] + ny * hi; czs[r] = zi[r] + nz * hi;
    cxs[CPL + r] = xj[r] - nx * hj; cys[CPL + r] = yj[r] - ny * hj; czs[CPL + r] = zj[r] - nz * hj;
  }
  // The rows are read; the records take the partner rows' place.
  __syncthreads();
  float* o = part + q * R;

  bool any_h = false;
  float v0 = 0.f, x0 = 0.f, y0 = 0.f, z0 = 0.f, f0 = 0.f;
  bool h0 = false;
  for (int m = 0; m < M; ++m) {
    // Candidate index of score sc[r]: i's corner g + G·r, or VH + j's.
    float lv = -INFINITY;
    int li = NO_IDX;
#pragma unroll
    for (int r = 0; r < 2 * CPL; ++r) {
      const int idx = r < CPL ? g + G * r : VH + g + G * (r - CPL);
      if (!isnan(sc[r]) && wins<true>(sc[r], idx, lv, li)) { lv = sc[r]; li = idx; }
    }
    const bool nan0 = __shfl_sync(FULL, (int)isnan(sc[0]), glane) != 0;  // candidate 0
    const int b = seq_argmax<G>(lv, li, 0, nan0);
    // The lane holding candidate b reads it out and retires it (selects
    // over the unrolled slots keep the arrays in registers).
    const int bv = b < VH ? b : b - VH;
    const int owner = glane + bv % G;
    const int rb = g == bv % G ? bv / G + (b < VH ? 0 : CPL) : -1;
    float mx = 0.f, px = 0.f, py = 0.f, pz = 0.f;
#pragma unroll
    for (int r = 0; r < 2 * CPL; ++r) {
      const bool here = r == rb;
      mx = here ? sc[r] : mx;
      px = here ? cxs[r] : px;
      py = here ? cys[r] : py;
      pz = here ? czs[r] : pz;
      sc[r] = here ? -BIG : sc[r];
    }
    mx = __shfl_sync(FULL, mx, owner);
    px = __shfl_sync(FULL, px, owner);
    py = __shfl_sync(FULL, py, owner);
    pz = __shfl_sync(FULL, pz, owner);
    const bool h = hit && (mx > -slop) && (mx < HALF_BIG);
    any_h = any_h || h;
    if (m == 0) {
      v0 = mx; h0 = h; x0 = px; y0 = py; z0 = pz; f0 = (float)(b + 1);
    } else if (g == 0 && q < npairs) {
      float* om = o + 5 + 6 * m;
      om[0] = mx; om[1] = h ? 1.0f : 0.0f; om[2] = px; om[3] = py; om[4] = pz;
      om[5] = (float)(b + 1);
    }
  }

  // Fallback when no corner is contained: the midpoint of the deepest
  // support corners (the first live corner of each hull when its value is
  // NaN, as the plain walk), fid 2Vh + fi·Vh + fj + 1.
  {
    float lvi = -INFINITY, lvj = -INFINITY;
    int lii = NO_IDX, lij = NO_IDX, fli = NO_IDX, flj = NO_IDX;
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      const int v = g + G * r;
      if (mi[r]) {
        fli = min(fli, v);
        if (!isnan(-si[r]) && wins<true>(-si[r], v, lvi, lii)) { lvi = -si[r]; lii = v; }
      }
      if (mj[r]) {
        flj = min(flj, v);
        if (!isnan(sj[r]) && wins<true>(sj[r], v, lvj, lij)) { lvj = sj[r]; lij = v; }
      }
    }
    fli = group_min_int<G>(fli);
    flj = group_min_int<G>(flj);
    // NaN-ness of each hull's first live corner, from the lane holding it.
    bool ni = false, nj = false;
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      ni = g + G * r == fli ? isnan(-si[r]) : ni;
      nj = g + G * r == flj ? isnan(sj[r]) : nj;
    }
    ni = __shfl_sync(FULL, (int)ni, glane + (fli == NO_IDX ? 0 : fli % G)) != 0;
    nj = __shfl_sync(FULL, (int)nj, glane + (flj == NO_IDX ? 0 : flj % G)) != 0;
    int fi = seq_argmax<G>(lvi, lii, fli, ni);
    int fj = seq_argmax<G>(lvj, lij, flj, nj);
    if (fli == NO_IDX) fi = -1;
    if (flj == NO_IDX) fj = -1;
    float pi[3] = {0.f, 0.f, 0.f}, pj[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      const bool ai = g + G * r == fi, aj = g + G * r == fj;
      pi[0] = ai ? xi[r] : pi[0]; pi[1] = ai ? yi[r] : pi[1]; pi[2] = ai ? zi[r] : pi[2];
      pj[0] = aj ? xj[r] : pj[0]; pj[1] = aj ? yj[r] : pj[1]; pj[2] = aj ? zj[r] : pj[2];
    }
    const int oi = glane + (fi < 0 ? 0 : fi % G), oj = glane + (fj < 0 ? 0 : fj % G);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pi[c] = __shfl_sync(FULL, pi[c], oi);
      pj[c] = __shfl_sync(FULL, pj[c], oj);
    }
    if (fi < 0) { pi[0] = 0.f; pi[1] = 0.f; pi[2] = 0.f; }
    if (fj < 0) { pj[0] = 0.f; pj[1] = 0.f; pj[2] = 0.f; }
    if (hit && !any_h) {
      x0 = 0.5f * (pi[0] + pj[0]);
      y0 = 0.5f * (pi[1] + pj[1]);
      z0 = 0.5f * (pi[2] + pj[2]);
      v0 = depth;
      h0 = true;
      f0 = (2.0f * VH + (float)(fi < 0 ? 0 : fi) * VH) + (float)(fj < 0 ? 0 : fj + 1);
    }
  }
  if (g == 0 && q < npairs) {
    o[0] = nx; o[1] = ny; o[2] = nz; o[3] = depth; o[4] = hit ? 1.0f : 0.0f;
    o[5] = v0; o[6] = h0 ? 1.0f : 0.0f; o[7] = x0; o[8] = y0; o[9] = z0; o[10] = f0;
  }
  __syncthreads();
  float* dst = out + (size_t)p0 * R;
  for (int k = tid; k < npairs * R; k += THREADS) dst[k] = part[k];
}

// A run of PB pairs spans at most (PB - 1) / K + 2 pieces: the floats of
// their rows, 16-byte aligned.
int own_floats(int PB, int K, int D) { return (((PB - 1) / K + 2) * D + 6 + 3) / 4 * 4; }

// Shared bytes of the staged kernel at this shape (narrowphase_cuda.staged_bytes
// mirrors it), 0 where it does not take the shape: Vh not 8, 16, 32 or 64, or a
// record (5 + 6M floats) wider than the staged row whose place it takes.
long long staged_smem(int vh, int K, int F, int NE, int M) {
  if (vh != 8 && vh != 16 && vh != 32 && vh != 64) return 0;
  const int PB = THREADS / (vh / 4);
  const int D = 4 * vh + 5 * F + 26 + 4 * NE;
  const int slot = row_slot(D);
  if (slot < 5 + 6 * M) return 0;
  return (long long)sizeof(float) * ((long long)own_floats(PB, K, D) + (long long)PB * slot);
}

template <int VH, int G>
int launch(const float* packed, const int* pidx, const uint8_t* pok, const float* dop, int Np,
           int K, int F, int NE, int M, float slop, float* out, cudaStream_t stream) {
  static_assert(G == VH / 4, "a group of Vh / 4 lanes a pair");
  constexpr int PB = THREADS / G;
  const int D = 4 * VH + 5 * F + 26 + 4 * NE;
  const size_t smem = (size_t)staged_smem(VH, K, F, NE, M);
  if (smem == 0) return (int)cudaErrorInvalidValue;   // records must fit the rows' place
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(narrow_kernel<VH, G>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int pairs = Np * K;
  narrow_kernel<VH, G><<<(pairs + PB - 1) / PB, THREADS, smem, stream>>>(
      packed, pidx, pok, dop, Np, K, F, NE, M, slop, own_floats(PB, K, D), out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The general variant, the last resort: one thread a pair, the rows read in
// place from the packed table, any Vh, F, Ne and M. It takes only what
// neither the staged kernel nor the group variant below takes (pair rows
// past a block's shared memory: Vh > 1,281 at K 1, F 26, Ne 3, M 4) and follows
// the plain version step for step: the folds propagate NaN as torch.amin /
// amax do, each
// corner's containment is a fold over the other hull's live planes, and
// the M picks walk the 2·Vh candidates in order, re-scoring each on every
// pick (a pick already taken counts -BIG, as the plain scatter leaves it;
// the taken indices are read back from the record's feature ids). Feature
// ids use the real Vh.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float nmin(float a, float b) { return (a != a || b != b) ? NAN : fminf(a, b); }
__device__ __forceinline__ float nmax(float a, float b) { return (a != a || b != b) ? NAN : fmaxf(a, b); }
__device__ __forceinline__ float dot3f(float x, float y, float z, float a, float b, float c) {
  return (x * a + y * b) + z * c;
}

// torch.nan_to_num(nan=BIG) as the argmin over the axes sees a value.
__device__ __forceinline__ float axis_key(float v) {
  if (v != v) return BIG;
  if (isinf(v)) return v > 0.f ? 3.4028234663852886e38f : -3.4028234663852886e38f;
  return v;
}

struct GRows {
  const float* I;
  const float* J;
  int Vh, F, NE;
  __device__ float ix(int v) const { return I[v]; }
  __device__ float iy(int v) const { return I[Vh + v]; }
  __device__ float iz(int v) const { return I[2 * Vh + v]; }
  __device__ bool im(int v) const { return I[3 * Vh + v] > 0.5f; }
  __device__ float jx(int v) const { return J[v]; }
  __device__ float jy(int v) const { return J[Vh + v]; }
  __device__ float jz(int v) const { return J[2 * Vh + v]; }
  __device__ bool jm(int v) const { return J[3 * Vh + v] > 0.5f; }
};

// Max over the live planes of `P` (a row) of corner (x, y, z)'s distance,
// -BIG where no plane is live: the containment fold of one corner.
__device__ inline float contain(const float* P, int Vh, int F, float x, float y, float z) {
  const int PN = 4 * Vh, PD = PN + 3 * F, PM = PN + 4 * F;
  float m = -BIG;
  for (int f = 0; f < F; ++f) {
    const float d = dot3f(x, y, z, P[PN + f], P[PN + F + f], P[PN + 2 * F + f]) + P[PD + f];
    m = nmax(m, P[PM + f] > 0.5f ? d : -BIG);
  }
  return m;
}

__global__ void __launch_bounds__(THREADS)
narrow_general_kernel(const float* __restrict__ packed, const int* __restrict__ pidx,
                      const uint8_t* __restrict__ pok, const float* __restrict__ dop, int Np,
                      int K, int Vh, int F, int NE, int M, float slop, float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= (long long)Np * K) return;
  const int i = (int)(p / K);
  int j = pidx[p];
  j = j < 0 ? 0 : (j >= Np ? Np - 1 : j);
  const long long D = 4LL * Vh + 5LL * F + 26 + 4LL * NE;
  const GRows g{packed + (size_t)i * D, packed + (size_t)j * D, Vh, F, NE};
  const float* I = g.I;
  const float* J = g.J;
  const int PN = 4 * Vh, PD = PN + 3 * F, PM = PN + 4 * F;
  const int LOD = PN + 5 * F, HID = LOD + 13, EX = HID + 13, EM = EX + 3 * NE;

  // Least penetration over the axes in family order, first of ties.
  float bkey = 0.f, bpen = 0.f, bnx = 0.f, bny = 0.f, bnz = 0.f;
  int bidx = -1;
  bool undefined = false;
  auto axis = [&](int t, bool live, float pen, float dx, float dy, float dz) {
    const float v = live ? pen : (isfinite(pen) ? BIG : NAN);
    undefined |= v != v;
    const float k = axis_key(v);
    if (bidx < 0 || k < bkey) { bkey = k; bpen = v; bidx = t; bnx = dx; bny = dy; bnz = dz; }
  };
  for (int t = 0; t < 13; ++t) {
    const float ilo = I[LOD + t], ihi = I[HID + t], jlo = J[LOD + t], jhi = J[HID + t];
    const float s = (ihi + ilo) < (jhi + jlo) ? -1.0f : 1.0f;
    axis(t, true, nmin(ihi, jhi) - nmax(ilo, jlo), s * dop[t * 3], s * dop[t * 3 + 1],
         s * dop[t * 3 + 2]);
  }
  for (int f = 0; f < F; ++f) {
    const float px = J[PN + f], py = J[PN + F + f], pz = J[PN + 2 * F + f], pd = J[PD + f];
    float mn = BIG;
    for (int v = 0; v < Vh; ++v)
      mn = nmin(mn, g.im(v) ? dot3f(g.ix(v), g.iy(v), g.iz(v), px, py, pz) + pd : BIG);
    axis(13 + f, J[PM + f] > 0.5f, -mn, px, py, pz);
  }
  for (int f = 0; f < F; ++f) {
    const float px = I[PN + f], py = I[PN + F + f], pz = I[PN + 2 * F + f], pd = I[PD + f];
    float mn = BIG;
    for (int v = 0; v < Vh; ++v)
      mn = nmin(mn, g.jm(v) ? dot3f(g.jx(v), g.jy(v), g.jz(v), px, py, pz) + pd : BIG);
    axis(13 + F + f, I[PM + f] > 0.5f, -mn, -px, -py, -pz);
  }
  for (int a = 0; a < NE; ++a) {
    for (int b = 0; b < NE; ++b) {
      const float ax = I[EX + a], ay = I[EX + NE + a], az = I[EX + 2 * NE + a];
      const float bx = J[EX + b], by = J[EX + NE + b], bz = J[EX + 2 * NE + b];
      float cx = ay * bz - az * by, cy = az * bx - ax * bz, cz = ax * by - ay * bx;
      const float nl = sqrtf((cx * cx + cy * cy) + cz * cz);
      const float inv = 1.0f / (nl != nl ? nl : fmaxf(nl, 1e-30f));
      cx = cx * inv; cy = cy * inv; cz = cz * inv;
      const bool live = (I[EM + a] > 0.5f) && (J[EM + b] > 0.5f) && (nl > 1e-6f);
      float ilo = BIG, ihi = -BIG, jlo = BIG, jhi = -BIG;
      for (int v = 0; v < Vh; ++v) {
        const float ti = dot3f(g.ix(v), g.iy(v), g.iz(v), cx, cy, cz);
        const float tj = dot3f(g.jx(v), g.jy(v), g.jz(v), cx, cy, cz);
        const bool mi = g.im(v), mj = g.jm(v);
        ilo = nmin(ilo, mi ? ti : BIG); ihi = nmax(ihi, mi ? ti : -BIG);
        jlo = nmin(jlo, mj ? tj : BIG); jhi = nmax(jhi, mj ? tj : -BIG);
      }
      const float s = (ihi + ilo) < (jhi + jlo) ? -1.0f : 1.0f;
      axis(13 + 2 * F + a * NE + b, live, nmin(ihi, jhi) - nmax(ilo, jlo), cx * s, cy * s,
           cz * s);
    }
  }
  const float depth = undefined ? NAN : bpen;
  const float nx = undefined ? 0.f : bnx, ny = undefined ? 0.f : bny, nz = undefined ? 0.f : bnz;
  const bool hit = (pok[p] != 0) && (depth > -slop) && (depth < HALF_BIG);

  // The containment manifold: candidate c < Vh is i's corner c, else j's
  // corner c - Vh; its score and contact point are computed where needed.
  float si_min = BIG, sj_max = -BIG;
  for (int v = 0; v < Vh; ++v) {
    si_min = nmin(si_min, g.im(v) ? dot3f(g.ix(v), g.iy(v), g.iz(v), nx, ny, nz) : BIG);
    sj_max = nmax(sj_max, g.jm(v) ? dot3f(g.jx(v), g.jy(v), g.jz(v), nx, ny, nz) : -BIG);
  }
  auto score = [&](int c) -> float {
    if (c < Vh) {
      if (!g.im(c)) return -BIG;
      const float x = g.ix(c), y = g.iy(c), z = g.iz(c);
      return contain(J, Vh, F, x, y, z) <= slop ? sj_max - dot3f(x, y, z, nx, ny, nz) : -BIG;
    }
    const int v = c - Vh;
    if (!g.jm(v)) return -BIG;
    const float x = g.jx(v), y = g.jy(v), z = g.jz(v);
    return contain(I, Vh, F, x, y, z) <= slop ? dot3f(x, y, z, nx, ny, nz) - si_min : -BIG;
  };
  const int R = 5 + 6 * M;
  float* o = out + (size_t)p * R;
  bool any_h = false;
  float v0 = 0.f, x0 = 0.f, y0 = 0.f, z0 = 0.f, f0 = 0.f;
  bool h0 = false;
  for (int m = 0; m < M; ++m) {
    // Sequential walk from candidate 0: a candidate replaces the best only
    // when strictly larger (NaN never does, a NaN candidate 0 stays).
    auto taken = [&](int c) {
      for (int q = 0; q < m; ++q)
        if ((int)(q == 0 ? f0 : o[5 + 6 * q + 5]) - 1 == c) return true;
      return false;
    };
    int b = 0;
    float best = taken(0) ? -BIG : score(0);
    for (int c = 1; c < 2 * Vh; ++c) {
      const float x = taken(c) ? -BIG : score(c);
      if (x > best) { best = x; b = c; }
    }
    float px, py, pz;
    if (b < Vh) {
      const float h = (sj_max - dot3f(g.ix(b), g.iy(b), g.iz(b), nx, ny, nz)) * 0.5f;
      px = g.ix(b) + nx * h; py = g.iy(b) + ny * h; pz = g.iz(b) + nz * h;
    } else {
      const int v = b - Vh;
      const float h = (dot3f(g.jx(v), g.jy(v), g.jz(v), nx, ny, nz) - si_min) * 0.5f;
      px = g.jx(v) - nx * h; py = g.jy(v) - ny * h; pz = g.jz(v) - nz * h;
    }
    const bool h = hit && (best > -slop) && (best < HALF_BIG);
    any_h = any_h || h;
    if (m == 0) {
      v0 = best; h0 = h; x0 = px; y0 = py; z0 = pz; f0 = (float)(b + 1);
    } else {
      float* om = o + 5 + 6 * m;
      om[0] = best; om[1] = h ? 1.0f : 0.0f; om[2] = px; om[3] = py; om[4] = pz;
      om[5] = (float)(b + 1);
    }
  }

  // Fallback when no corner is contained: the deepest support corners
  // (argmax of where(mask, -si, -BIG) and of where(mask, sj, -BIG)).
  if (hit && !any_h) {
    int fi = 0, fj = 0;
    bool has_i = false, has_j = false;
    float bi = -BIG, bj = -BIG;
    for (int v = 0; v < Vh; ++v) {
      const bool mi = g.im(v), mj = g.jm(v);
      has_i |= mi;
      has_j |= mj;
      const float ci = mi ? -dot3f(g.ix(v), g.iy(v), g.iz(v), nx, ny, nz) : -BIG;
      const float cj = mj ? dot3f(g.jx(v), g.jy(v), g.jz(v), nx, ny, nz) : -BIG;
      if (v == 0) { bi = ci; bj = cj; }
      if (ci > bi) { bi = ci; fi = v; }
      if (cj > bj) { bj = cj; fj = v; }
    }
    const float pix = has_i ? g.ix(fi) : 0.f, piy = has_i ? g.iy(fi) : 0.f,
                piz = has_i ? g.iz(fi) : 0.f;
    const float pjx = has_j ? g.jx(fj) : 0.f, pjy = has_j ? g.jy(fj) : 0.f,
                pjz = has_j ? g.jz(fj) : 0.f;
    x0 = 0.5f * (pix + pjx);
    y0 = 0.5f * (piy + pjy);
    z0 = 0.5f * (piz + pjz);
    v0 = depth;
    h0 = true;
    f0 = (2.0f * (float)Vh + (float)(has_i ? fi : 0) * (float)Vh) + (float)(has_j ? fj + 1 : 0);
  }
  o[0] = nx; o[1] = ny; o[2] = nz; o[3] = depth; o[4] = hit ? 1.0f : 0.0f;
  o[5] = v0; o[6] = h0 ? 1.0f : 0.0f; o[7] = x0; o[8] = y0; o[9] = z0; o[10] = f0;
}

// ---------------------------------------------------------------------------
// The group variant: any Vh whose block of pair rows fits a block's opt-in
// shared memory (the staged kernel above takes Vh = 8, 16, 32 and 64 with
// records no wider than a row). It stages rows as the staged kernel does
// (the block's own rows one span, each pair's partner row copied by a warp,
// 16 bytes a lane) and gives each pair a group of G lanes, G the least
// power of two with 6·G >= Vh, at most 32 (group_lanes: 2 at Vh = 12, 32
// past Vh = 96). A lane holds its corners v = g + G·r < Vh of both hulls in
// registers, CPL = ceil(Vh / G) of each (4 to 6; at Vh 12, (1,000, 32)
// pairs, two lanes of six measured 0.024 ms against four lanes of three's
// 0.031 on an NVIDIA H100 80GB HBM3 at 700 W); past Vh = 192 (CPL 0 in
// the template) it reads them from the staged rows. Its rules are the
// general variant's, so its bits are the plain version's, NaN included:
// - the DOP axes go round the group's lanes; the face and edge axes' folds
//   over the corners end in group reductions by min / max that return NaN
//   when either side is NaN (PTX min.NaN / max.NaN; -0 below +0, so any
//   tree gives the fold's bits); the least axis is a group reduction on
//   (axis_key, family index), first of ties;
// - each corner's containment fold over the other hull's F planes rides on
//   the face folds (a second pass past Vh = 192), so each of the 2Vh
//   candidates is scored once, into shared memory; each of the M picks is
//   a group arg-max on (score, candidate) as torch.argmax takes it (the
//   plain version's): the first NaN if any, else the first of the maxima
//   (a NaN candidate 0 stays, as in the staged and general variants' walk,
//   which differs only where a later candidate is NaN); the pick's score
//   is then overwritten by -BIG, as the plain scatter does: that is the
//   taken mask;
// - the fallback's support corners are group arg-maxes under the same rule;
// - records no wider than a staged row are assembled in shared memory and
//   written as one span, wider ones by the group's first lane.
// What bounds it: operations, 2 x 2Vh x F plane distances and the Ne^2 x
// 4Vh edge projections a pair (the general variant took M x 2Vh x F more,
// re-scoring every candidate on every pick, from rows read in place).
// ---------------------------------------------------------------------------

constexpr int CORNERS = 6;   // corners of each hull a lane holds at most

// Lanes of a pair's group in the group variant.
__host__ __device__ inline int group_lanes(int Vh) {
  int g = 1;
  while (g < 32 && CORNERS * g < Vh) g *= 2;
  return g;
}

// Corners of each hull a lane holds in registers: 4 to 6, 0 past 6·G.
__host__ __device__ inline int group_cpl(int Vh, int G) {
  const int c = (Vh + G - 1) / G;
  return c > CORNERS ? 0 : (c < CORNERS / 2 + 1 ? CORNERS / 2 + 1 : c);
}

// Floats a staged partner row takes in the group variant: the row slot,
// padded so that the groups of a warp start max(G, 4) banks apart.
__host__ __device__ inline int group_slot(int D, int G) {
  int s = row_slot(D);
  if (G < 32) {
    const int want = G < 4 ? 4 : G;
    s += ((want - s % 32) % 32 + 32) % 32;
  }
  return s;
}

// Shared bytes of the group variant (narrowphase_cuda.group_bytes mirrors
// it): the own rows' span, PB partner rows, PB x 2Vh scores and, where a
// record fits a row slot, PB records.
long long group_smem(int Vh, int K, int F, int NE, int M) {
  const int G = group_lanes(Vh), PB = THREADS / G;
  const int D = 4 * Vh + 5 * F + 26 + 4 * NE;
  const int slot = group_slot(D, G), R = 5 + 6 * M;
  const long long floats = (long long)own_floats(PB, K, D) + (long long)PB * slot +
                           (long long)PB * 2 * Vh + (R <= slot ? (long long)PB * R : 0);
  return 4 * floats;
}

// min / max that return NaN when either input is NaN (torch.amin / amax).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <int G>
__device__ __forceinline__ float group_nmin(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = min_nan(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ float group_nmax(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ bool group_any(bool b) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const int ob = __shfl_xor_sync(FULL, (int)b, o);   // every lane shuffles
    b = b || ob != 0;
  }
  return b;
}

// (x, j) beats (v, i) as torch.argmax orders candidates: NaN above every
// number, then the larger value, then the lower index.
__device__ __forceinline__ bool argmax_wins(float x, int j, float v, int i) {
  const bool xn = isnan(x), vn = isnan(v);
  if (xn != vn) return xn;
  return (xn || x == v) ? j < i : x > v;
}

// torch.argmax over candidates c < n, each lane scoring c = g, g + G, ...:
// the first NaN if any, else the first of the maxima. Returns the index;
// `val` its value.
template <int G, typename Score>
__device__ __forceinline__ int group_argmax(int n, int g, Score x, float& val) {
  float lv = -INFINITY;
  int li = NO_IDX;
  for (int c = g; c < n; c += G) {
    const float s = x(c);
    if (argmax_wins(s, c, lv, li)) { lv = s; li = c; }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, lv, o);
    const int oi = __shfl_xor_sync(FULL, li, o);
    if (argmax_wins(ov, oi, lv, li)) { lv = ov; li = oi; }
  }
  val = lv;
  return li;
}

template <int G, int CPL>
__global__ void __launch_bounds__(THREADS, CPL > 4 ? 4 : 6)
narrow_group_kernel(const float* __restrict__ packed, const int* __restrict__ pidx,
                    const uint8_t* __restrict__ pok, const float* __restrict__ dop, int Np,
                    int K, int Vh, int F, int NE, int M, float slop, int own_cap,
                    float* __restrict__ out) {
  constexpr int PB = THREADS / G;      // pairs a block
  constexpr int RC = CPL > 0 ? CPL : 1;
  extern __shared__ float4 sm4[];
  __shared__ float dop_s[39];
  float* sm = reinterpret_cast<float*>(sm4);
  const int D = 4 * Vh + 5 * F + 26 + 4 * NE;
  const int SLOT = group_slot(D, G);
  const int R = 5 + 6 * M;
  const bool rec_shared = R <= SLOT;
  float* own = sm;                     // the block's own rows, a 16-byte aligned span
  float* part = own + own_cap;         // PB partner rows, SLOT floats each
  float* scores = part + PB * SLOT;    // PB x 2Vh candidate scores
  float* recs = scores + PB * 2 * Vh;  // PB records (rec_shared)
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int P = Np * K;
  const int p0 = blockIdx.x * PB;
  const int npairs = min(PB, P - p0);

  // --- stage the own rows (one span) and each pair's partner row (a warp
  // a row), 16 bytes a lane ---
  const int i_lo = p0 / K, i_hi = (p0 + npairs - 1) / K;
  const long long os4 = ((long long)i_lo * D) >> 2;
  const int on4 = (int)((((long long)(i_hi + 1) * D + 3) >> 2) - os4);
  // A warp's rows r = warp + 4·t: lane t holds row t's partner, so all of
  // the warp's index loads are in flight at once, and two rows' copies are.
  const float4* src = reinterpret_cast<const float4*>(packed);
  for (int v = tid; v < on4; v += THREADS) reinterpret_cast<float4*>(own)[v] = src[os4 + v];
  const int wrows = npairs > warp ? (npairs - warp + 3) / 4 : 0;
  int jl = 0;
  if (wl < wrows) {
    jl = pidx[p0 + warp + 4 * wl];
    jl = jl < 0 ? 0 : (jl >= Np ? Np - 1 : jl);
  }
#pragma unroll 2
  for (int t = 0; t < wrows; ++t) {
    const int j = __shfl_sync(FULL, jl, t);
    const long long js4 = ((long long)j * D) >> 2;
    const int jn4 = (int)((((long long)(j + 1) * D + 3) >> 2) - js4);
    float4* dst = reinterpret_cast<float4*>(part + (warp + 4 * t) * SLOT);
    for (int v = wl; v < jn4; v += 32) dst[v] = src[js4 + v];
  }
  if (tid < 39) dop_s[tid] = dop[tid];

  // --- one group of G lanes a pair ---
  const int q = tid / G, g = tid - q * G;
  const int glane = wl - g;            // the group's first lane in the warp
  const int qe = q < npairs ? q : 0;   // lanes past the last pair shadow pair 0
  const int p = p0 + qe;
  const int i = p / K;
  int j = pidx[p];
  j = j < 0 ? 0 : (j >= Np ? Np - 1 : j);
  const bool own_pok = pok[p] != 0;
  __syncthreads();
  const float* I = own + (int)((long long)i * D - 4 * os4);
  const float* J = part + qe * SLOT + (int)((long long)j * D - 4 * ((((long long)j * D) >> 2)));
  const int PN = 4 * Vh, PD = PN + 3 * F, PM = PN + 4 * F;
  const int LOD = PN + 5 * F, HID = LOD + 13, EX = HID + 13, EM = EX + 3 * NE;
  const int VY = Vh, VZ = 2 * Vh, VM = 3 * Vh;

  // This lane's corners v = g + G·r < Vh of both hulls, in registers, with
  // their containment folds over the other hull's live planes.
  float xi[RC], yi[RC], zi[RC], xj[RC], yj[RC], zj[RC], ins_j[RC], ins_i[RC];
  bool mi[RC], mj[RC];
  if constexpr (CPL > 0) {
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      const int v = g + G * r;
      xi[r] = yi[r] = zi[r] = xj[r] = yj[r] = zj[r] = 0.f;
      mi[r] = mj[r] = false;
      if (v < Vh) {
        xi[r] = I[v]; yi[r] = I[VY + v]; zi[r] = I[VZ + v]; mi[r] = I[VM + v] > 0.5f;
        xj[r] = J[v]; yj[r] = J[VY + v]; zj[r] = J[VZ + v]; mj[r] = J[VM + v] > 0.5f;
      }
      ins_j[r] = -BIG;
      ins_i[r] = -BIG;
    }
  }

  // Least penetration over the axes in family order, first of ties: each
  // lane keeps its best (key, index), the group's least is a reduction.
  float bkey = INFINITY, bpen = 0.f, bnx = 0.f, bny = 0.f, bnz = 0.f;
  int bidx = NO_IDX;
  bool undefined = false;
  auto axis = [&](int t, bool live, float pen, float dx, float dy, float dz) {
    const float v = live ? pen : (isfinite(pen) ? BIG : NAN);
    undefined |= v != v;
    const float k = axis_key(v);
    if (k < bkey) { bkey = k; bpen = v; bidx = t; bnx = dx; bny = dy; bnz = dz; }
  };
  // (1) 26-DOP interval axes, round the group's lanes.
  for (int t = g; t < 13; t += G) {
    const float ilo = I[LOD + t], ihi = I[HID + t], jlo = J[LOD + t], jhi = J[HID + t];
    const float s = (ihi + ilo) < (jhi + jlo) ? -1.0f : 1.0f;
    axis(t, true, min_nan(ihi, jhi) - max_nan(ilo, jlo), s * dop_s[t * 3],
         s * dop_s[t * 3 + 1], s * dop_s[t * 3 + 2]);
  }
  // (2) i's corners against j's planes, with their containment in j; (3)
  // j's corners against i's planes.
  for (int f = 0; f < F; ++f) {
    const float px = J[PN + f], py = J[PN + F + f], pz = J[PN + 2 * F + f], pd = J[PD + f];
    const bool live = J[PM + f] > 0.5f;
    float mn = BIG;
    if constexpr (CPL > 0) {
#pragma unroll
      for (int r = 0; r < CPL; ++r) {
        const float d = dot3f(xi[r], yi[r], zi[r], px, py, pz) + pd;
        if (mi[r]) mn = min_nan(mn, d);
        ins_j[r] = max_nan(ins_j[r], live ? d : -BIG);
      }
    } else {
      for (int v = g; v < Vh; v += G)
        if (I[VM + v] > 0.5f) mn = min_nan(mn, dot3f(I[v], I[VY + v], I[VZ + v], px, py, pz) + pd);
    }
    axis(13 + f, live, -group_nmin<G>(mn), px, py, pz);
  }
  for (int f = 0; f < F; ++f) {
    const float px = I[PN + f], py = I[PN + F + f], pz = I[PN + 2 * F + f], pd = I[PD + f];
    const bool live = I[PM + f] > 0.5f;
    float mn = BIG;
    if constexpr (CPL > 0) {
#pragma unroll
      for (int r = 0; r < CPL; ++r) {
        const float d = dot3f(xj[r], yj[r], zj[r], px, py, pz) + pd;
        if (mj[r]) mn = min_nan(mn, d);
        ins_i[r] = max_nan(ins_i[r], live ? d : -BIG);
      }
    } else {
      for (int v = g; v < Vh; v += G)
        if (J[VM + v] > 0.5f) mn = min_nan(mn, dot3f(J[v], J[VY + v], J[VZ + v], px, py, pz) + pd);
    }
    axis(13 + F + f, live, -group_nmin<G>(mn), -px, -py, -pz);
  }
  // (4) edge x edge cross axes, i's edge major; the group's lanes take turns
  // normalizing an axis and pass it round by shuffles.
  const int NE2 = NE * NE;
  for (int e0 = 0; e0 < NE2; e0 += G) {
    float cx = 0.f, cy = 0.f, cz = 0.f;
    bool live = false;
    if (e0 + g < NE2) {
      const int a = (e0 + g) / NE, b = (e0 + g) - a * NE;
      const float ax = I[EX + a], ay = I[EX + NE + a], az = I[EX + 2 * NE + a];
      const float bx = J[EX + b], by = J[EX + NE + b], bz = J[EX + 2 * NE + b];
      cx = ay * bz - az * by;
      cy = az * bx - ax * bz;
      cz = ax * by - ay * bx;
      const float nl = sqrtf((cx * cx + cy * cy) + cz * cz);
      const float inv = 1.0f / (nl != nl ? nl : fmaxf(nl, 1e-30f));
      cx = cx * inv; cy = cy * inv; cz = cz * inv;
      live = (I[EM + a] > 0.5f) && (J[EM + b] > 0.5f) && (nl > 1e-6f);
    }
    const int n = min(G, NE2 - e0);
    for (int k = 0; k < n; ++k) {
      const float ux = __shfl_sync(FULL, cx, glane + k);
      const float uy = __shfl_sync(FULL, cy, glane + k);
      const float uz = __shfl_sync(FULL, cz, glane + k);
      const bool ul = __shfl_sync(FULL, (int)live, glane + k) != 0;
      float ilo = BIG, ihi = -BIG, jlo = BIG, jhi = -BIG;
      if constexpr (CPL > 0) {
#pragma unroll
        for (int r = 0; r < CPL; ++r) {
          const float ti = dot3f(xi[r], yi[r], zi[r], ux, uy, uz);
          const float tj = dot3f(xj[r], yj[r], zj[r], ux, uy, uz);
          if (mi[r]) { ilo = min_nan(ilo, ti); ihi = max_nan(ihi, ti); }
          if (mj[r]) { jlo = min_nan(jlo, tj); jhi = max_nan(jhi, tj); }
        }
      } else {
        for (int v = g; v < Vh; v += G) {
          if (I[VM + v] > 0.5f) {
            const float ti = dot3f(I[v], I[VY + v], I[VZ + v], ux, uy, uz);
            ilo = min_nan(ilo, ti); ihi = max_nan(ihi, ti);
          }
          if (J[VM + v] > 0.5f) {
            const float tj = dot3f(J[v], J[VY + v], J[VZ + v], ux, uy, uz);
            jlo = min_nan(jlo, tj); jhi = max_nan(jhi, tj);
          }
        }
      }
      ilo = group_nmin<G>(ilo); ihi = group_nmax<G>(ihi);
      jlo = group_nmin<G>(jlo); jhi = group_nmax<G>(jhi);
      const float s = (ihi + ilo) < (jhi + jlo) ? -1.0f : 1.0f;
      axis(13 + 2 * F + e0 + k, ul, min_nan(ihi, jhi) - max_nan(ilo, jlo), ux * s, uy * s,
           uz * s);
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float ok = __shfl_xor_sync(FULL, bkey, o);
    const int oi = __shfl_xor_sync(FULL, bidx, o);
    const float op = __shfl_xor_sync(FULL, bpen, o);
    const float ox = __shfl_xor_sync(FULL, bnx, o);
    const float oy = __shfl_xor_sync(FULL, bny, o);
    const float oz = __shfl_xor_sync(FULL, bnz, o);
    undefined |= __shfl_xor_sync(FULL, (int)undefined, o) != 0;
    if (wins<false>(ok, oi, bkey, bidx)) {
      bkey = ok; bidx = oi; bpen = op; bnx = ox; bny = oy; bnz = oz;
    }
  }
  const float depth = undefined ? NAN : bpen;
  const float nx = undefined ? 0.f : bnx, ny = undefined ? 0.f : bny, nz = undefined ? 0.f : bnz;
  const bool hit = own_pok && (depth > -slop) && (depth < HALF_BIG);

  // --- the containment manifold: each candidate scored once ---
  float si_min = BIG, sj_max = -BIG;
  float si[RC], sj[RC];
  if constexpr (CPL > 0) {
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      si[r] = dot3f(xi[r], yi[r], zi[r], nx, ny, nz);
      sj[r] = dot3f(xj[r], yj[r], zj[r], nx, ny, nz);
      if (mi[r]) si_min = min_nan(si_min, si[r]);
      if (mj[r]) sj_max = max_nan(sj_max, sj[r]);
    }
  } else {
    for (int v = g; v < Vh; v += G) {
      if (I[VM + v] > 0.5f) si_min = min_nan(si_min, dot3f(I[v], I[VY + v], I[VZ + v], nx, ny, nz));
      if (J[VM + v] > 0.5f) sj_max = max_nan(sj_max, dot3f(J[v], J[VY + v], J[VZ + v], nx, ny, nz));
    }
  }
  si_min = group_nmin<G>(si_min);
  sj_max = group_nmax<G>(sj_max);
  float* sc = scores + q * 2 * Vh;
  if constexpr (CPL > 0) {
#pragma unroll
    for (int r = 0; r < CPL; ++r) {
      const int v = g + G * r;
      if (v < Vh) {
        sc[v] = (mi[r] && ins_j[r] <= slop) ? sj_max - si[r] : -BIG;
        sc[Vh + v] = (mj[r] && ins_i[r] <= slop) ? sj[r] - si_min : -BIG;
      }
    }
  } else {
    for (int v = g; v < Vh; v += G) {
      float s = -BIG;
      if (I[VM + v] > 0.5f) {
        const float x = I[v], y = I[VY + v], z = I[VZ + v];
        if (contain(J, Vh, F, x, y, z) <= slop) s = sj_max - dot3f(x, y, z, nx, ny, nz);
      }
      sc[v] = s;
      s = -BIG;
      if (J[VM + v] > 0.5f) {
        const float x = J[v], y = J[VY + v], z = J[VZ + v];
        if (contain(I, Vh, F, x, y, z) <= slop) s = dot3f(x, y, z, nx, ny, nz) - si_min;
      }
      sc[Vh + v] = s;
    }
  }
  __syncwarp();

  const bool write = g == 0 && q < npairs;
  float* o = rec_shared ? recs + q * R : out + (size_t)p * R;
  bool any_h = false;
  float v0 = 0.f, x0 = 0.f, y0 = 0.f, z0 = 0.f, f0 = 0.f;
  bool h0 = false;
  for (int m = 0; m < M; ++m) {
    float best;
    const int b = group_argmax<G>(2 * Vh, g, [&](int c) { return sc[c]; }, best);
    float px, py, pz;
    if (b < Vh) {
      const float h = (sj_max - dot3f(I[b], I[VY + b], I[VZ + b], nx, ny, nz)) * 0.5f;
      px = I[b] + nx * h; py = I[VY + b] + ny * h; pz = I[VZ + b] + nz * h;
    } else {
      const int v = b - Vh;
      const float h = (dot3f(J[v], J[VY + v], J[VZ + v], nx, ny, nz) - si_min) * 0.5f;
      px = J[v] - nx * h; py = J[VY + v] - ny * h; pz = J[VZ + v] - nz * h;
    }
    __syncwarp();                      // the group has read the scores
    if (g == 0) sc[b] = -BIG;          // taken
    __syncwarp();
    const bool h = hit && (best > -slop) && (best < HALF_BIG);
    any_h = any_h || h;
    if (m == 0) {
      v0 = best; h0 = h; x0 = px; y0 = py; z0 = pz; f0 = (float)(b + 1);
    } else if (write) {
      float* om = o + 5 + 6 * m;
      om[0] = best; om[1] = h ? 1.0f : 0.0f; om[2] = px; om[3] = py; om[4] = pz;
      om[5] = (float)(b + 1);
    }
  }

  // Fallback when no corner is contained: the deepest support corners
  // (the walks over where(mask, -si, -BIG) and where(mask, sj, -BIG)).
  {
    float bi, bj;
    const int fi = group_argmax<G>(Vh, g, [&](int v) {
      return I[VM + v] > 0.5f ? -dot3f(I[v], I[VY + v], I[VZ + v], nx, ny, nz) : -BIG; }, bi);
    const int fj = group_argmax<G>(Vh, g, [&](int v) {
      return J[VM + v] > 0.5f ? dot3f(J[v], J[VY + v], J[VZ + v], nx, ny, nz) : -BIG; }, bj);
    bool li = false, lj = false;
    for (int v = g; v < Vh; v += G) {
      li = li || I[VM + v] > 0.5f;
      lj = lj || J[VM + v] > 0.5f;
    }
    const bool has_i = group_any<G>(li), has_j = group_any<G>(lj);
    if (hit && !any_h) {
      const float pix = has_i ? I[fi] : 0.f, piy = has_i ? I[VY + fi] : 0.f,
                  piz = has_i ? I[VZ + fi] : 0.f;
      const float pjx = has_j ? J[fj] : 0.f, pjy = has_j ? J[VY + fj] : 0.f,
                  pjz = has_j ? J[VZ + fj] : 0.f;
      x0 = 0.5f * (pix + pjx);
      y0 = 0.5f * (piy + pjy);
      z0 = 0.5f * (piz + pjz);
      v0 = depth;
      h0 = true;
      f0 = (2.0f * (float)Vh + (float)(has_i ? fi : 0) * (float)Vh) +
           (float)(has_j ? fj + 1 : 0);
    }
  }
  if (write) {
    o[0] = nx; o[1] = ny; o[2] = nz; o[3] = depth; o[4] = hit ? 1.0f : 0.0f;
    o[5] = v0; o[6] = h0 ? 1.0f : 0.0f; o[7] = x0; o[8] = y0; o[9] = z0; o[10] = f0;
  }
  if (rec_shared) {
    __syncthreads();
    float* dst = out + (size_t)p0 * R;
    for (int k = tid; k < npairs * R; k += THREADS) dst[k] = recs[k];
  }
}

template <int G, int CPL>
int launch_group(const float* packed, const int* pidx, const uint8_t* pok, const float* dop,
                 int Np, int K, int Vh, int F, int NE, int M, float slop, float* out,
                 cudaStream_t stream) {
  constexpr int PB = THREADS / G;
  const int D = 4 * Vh + 5 * F + 26 + 4 * NE;
  const long long smem = group_smem(Vh, K, F, NE, M);
  if (smem > 232448 - 39 * 4) return (int)cudaErrorInvalidValue;   // beside the DOP table
  static long long set_smem = 48 * 1024;
  if (smem > set_smem) {
    const cudaError_t e = cudaFuncSetAttribute(narrow_group_kernel<G, CPL>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    set_smem = smem;
  }
  const long long pairs = (long long)Np * K;
  narrow_group_kernel<G, CPL><<<(unsigned)((pairs + PB - 1) / PB), THREADS, (size_t)smem,
                                stream>>>(packed, pidx, pok, dop, Np, K, Vh, F, NE, M, slop,
                                          own_floats(PB, K, D), out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long surtr_narrowphase_group_bytes(int Vh, int K, int F, int Ne, int M) {
  return group_smem(Vh, K, F, Ne, M);
}

// The group variant (any Vh >= 1 whose rows fit a block's shared memory;
// packed must start 16-byte aligned, as for the staged variant).
extern "C" int surtr_narrowphase_group(const float* packed, const int* pidx, const uint8_t* pok,
                                       const float* dop, int Np, int K, int Vh, int F, int Ne,
                                       int M, float slop, float* out, void* stream) {
  if (Np * K == 0) return 0;
  if (M < 1 || Vh < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = group_lanes(Vh), cpl = group_cpl(Vh, G);
#define SURTR_GROUP(g, c)                                                                     \
  if (G == g && cpl == c)                                                                     \
    return launch_group<g, c>(packed, pidx, pok, dop, Np, K, Vh, F, Ne, M, slop, out, s);
  SURTR_GROUP(1, 4) SURTR_GROUP(1, 5) SURTR_GROUP(1, 6) SURTR_GROUP(2, 4) SURTR_GROUP(2, 5)
  SURTR_GROUP(2, 6) SURTR_GROUP(4, 4) SURTR_GROUP(4, 5) SURTR_GROUP(4, 6) SURTR_GROUP(8, 4)
  SURTR_GROUP(8, 5) SURTR_GROUP(8, 6) SURTR_GROUP(16, 4) SURTR_GROUP(16, 5) SURTR_GROUP(16, 6)
  SURTR_GROUP(32, 4) SURTR_GROUP(32, 5) SURTR_GROUP(32, 6) SURTR_GROUP(32, 0)
#undef SURTR_GROUP
  return (int)cudaErrorInvalidValue;
}

extern "C" long long surtr_narrowphase_staged_bytes(int Vh, int K, int F, int Ne, int M) {
  return staged_smem(Vh, K, F, Ne, M);
}

// The staged variant (Vh 8, 16, 32, 64; packed must start 16-byte aligned,
// the wrapper checks) or, with `general`, the thread-a-pair last resort
// (the wrapper's narrowphase_cuda._variant mirrors launch()'s and
// launch_group()'s shared-memory sizes).
extern "C" int surtr_narrowphase(const float* packed, const int* pidx, const uint8_t* pok,
                                 const float* dop, int Np, int K, int Vh, int F, int Ne, int M,
                                 float slop, int general, float* out, void* stream) {
  if (Np * K == 0) return 0;
  if (M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (general) {
    const long long pairs = (long long)Np * K;
    narrow_general_kernel<<<(unsigned)((pairs + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        packed, pidx, pok, dop, Np, K, Vh, F, Ne, M, slop, out);
    return (int)cudaGetLastError();
  }
  switch (Vh) {
    case 8: return launch<8, 2>(packed, pidx, pok, dop, Np, K, F, Ne, M, slop, out, s);
    case 16: return launch<16, 4>(packed, pidx, pok, dop, Np, K, F, Ne, M, slop, out, s);
    case 32: return launch<32, 8>(packed, pidx, pok, dop, Np, K, F, Ne, M, slop, out, s);
    case 64: return launch<64, 16>(packed, pidx, pok, dop, Np, K, F, Ne, M, slop, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
