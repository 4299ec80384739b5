// Contact prep for the single-piece solver, from the narrowphase's pair
// records (kernel B8).
//
// Replaces: surtr_tpu/physics/prep_pallas.py `_prep_kernel` (wrapper
// `prep_contacts_pallas`) together with the slot assembly and partner gather
// that the JAX package's step does in XLA before it. Semantics of the plain
// version in surtr_tpu_torch/physics/prep_cuda.py
// `prep_from_records_reference`: the slot tables (slot m·K + k reads pair k's
// manifold point m: depth clamped at 0 with NaN kept, hit, point; then G
// ground slots with normal +y and a static partner), the partner fields of
// body clamp(pidx, 0, Np - 1) [x | inv_m | inv_I | v0 | w0 | asleep], and then
// per slot the lever arms rA, rB; kA = inv_m + (rA x n).I⁻¹(rA x n) and kB
// likewise for a live partner; m_eff = 1/max(kA + kB, 1e-12) on hit slots;
// vn0 = (vA0 - vB0).n; the target max(-e·min(vn0 + thr, 0), (β/dt)·max(max(d,
// 0) - slop, 0)) with no bias against a sleeping partner; per row the
// mass-splitting scale 1/max(#hits, 1). Every clamp and maximum keeps NaN as
// PyTorch's do (a dead partner's slot has NaN depth).
//
// What bounds it on the card: bytes. Per row it reads its K records (K·(5 +
// 6M) floats), its K partners' 20 fields, its own 19 and G ground slots, and
// writes 13C + 11 floats: ~2.6 KB at K = 8, M = 4, G = 4, C = 36, ~80 flops a
// slot; 26 MB at 10k rows, about 8 us at 3.35 TB/s. Design: a block of 256
// threads takes RB rows (RB·C ≈ 256) and stages in shared memory their
// records (one contiguous span), their ground slots and own fields, and their
// partners' fields gathered from L2 (odd row stride: no bank conflicts).
// Then one thread a (row, slot), consecutive threads on consecutive slots, so
// each [x | y | z] segment of C floats is written coalesced; one thread a row
// sums its hits in slot order from shared memory (a sum of 0/1, exact in any
// order). Division and comparisons are IEEE (no fast math) and -fmad=false
// keeps every rounding of the plain version.
//
// Rows past the 48 KB a block takes without opting in (K = 32, M = 64: a
// row stages 60,844 B) take the wide variant, prep_wide_kernel: one CTA a
// row, its partners' fields gathered into shared memory KC at a time (as
// many as a third of the SM's opt-in shared memory holds, so at least three
// CTAs an SM), with them their records staged by 16-byte copies (STAGE) or
// read in place where one partner's record passes that room; the ground
// slots read in place. The hit count is a block vote (__syncthreads_count of hit > 0.5
// a pass over the slots): the narrowphase's records and the ground flags
// carry hits of exactly 0 or 1, so the count equals the plain version's
// sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PS = 21;  // shared stride of a partner's 20 fields
constexpr int MAX_SMEM = 232448;          // opt-in dynamic shared memory a block, H100
constexpr int WIDE_ROOM = MAX_SMEM / 3;   // the wide variant's shared memory at most

// Floats one row stages: its K records, K partners' fields, own 19 fields,
// G ground slots (5 floats) and C slot hits (prep_cuda.row_bytes mirrors it).
__host__ __device__ inline int row_floats(int K, int M, int G) {
  return K * (5 + 6 * M) + K * PS + 19 + 5 * G + K * M + G;
}

// PyTorch's clamp and maximum as its CUDA kernels compute them: NaN in, NaN
// out (fmaxf/fminf alone would drop it), else fmaxf/fminf.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v != v ? v : fminf(v, hi); }
__device__ __forceinline__ float maximum(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// One slot's tables for the wide variant, written at column c of row
// `row`: the own fields ow [x | v0 | w0 | inv_m | inv_I] and, for a pair
// slot, the partner's pf [x | inv_m | inv_I | v0 | w0 | asleep]; the slot's
// normal (0 for a ground slot), point, depth and hit. The formulas of
// prep_kernel's slot loop in its order; prep_kernel keeps its own copy
// inline, since calling this function changed its register allocation
// (its SASS is kept as it was). The card holds both bit for bit against
// the plain version.
__device__ __forceinline__ void slot_tables(
    const float* ow, const float* pf, bool pair, float nx, float ny, float nz, float px,
    float py, float pz, float dep, float hit, size_t row, int C, int c, float* __restrict__ rA,
    float* __restrict__ rB, float* __restrict__ nrm, float* __restrict__ mt,
    float* __restrict__ hs, float* __restrict__ vn0_out, float slop, float bias_coef,
    float neg_rest, float bounce_thr) {
  const float ground = pair ? 0.0f : 1.0f;
  // Partner fields tile over the M manifold slots; ground slots read 0.
  auto bf = [&](int field) { return pair ? pf[field] : 0.0f; };
  dep = clamp_min(dep, 0.0f);  // the slot table's depth
  ny = ny + ground;
  const float stat = clamp_max(bf(19) + ground, 1.0f);
  const float live = 1.0f - stat;

  const float ox = ow[0], oy = ow[1], oz = ow[2];
  const float rAx = px - ox, rAy = py - oy, rAz = pz - oz;
  const float rBx = px - bf(0), rBy = py - bf(1), rBz = pz - bf(2);

  const float cAx = rAy * nz - rAz * ny;
  const float cAy = rAz * nx - rAx * nz;
  const float cAz = rAx * ny - rAy * nx;
  const float tAx = (ow[10] * cAx + ow[11] * cAy) + ow[12] * cAz;
  const float tAy = (ow[13] * cAx + ow[14] * cAy) + ow[15] * cAz;
  const float tAz = (ow[16] * cAx + ow[17] * cAy) + ow[18] * cAz;
  const float kA = ((ow[9] + cAx * tAx) + cAy * tAy) + cAz * tAz;
  const float cBx = rBy * nz - rBz * ny;
  const float cBy = rBz * nx - rBx * nz;
  const float cBz = rBx * ny - rBy * nx;
  const float tBx = (bf(4) * cBx + bf(5) * cBy) + bf(6) * cBz;
  const float tBy = (bf(7) * cBx + bf(8) * cBy) + bf(9) * cBz;
  const float tBz = (bf(10) * cBx + bf(11) * cBy) + bf(12) * cBz;
  const float kB = live * (((bf(3) + cBx * tBx) + cBy * tBy) + cBz * tBz);
  const float kn = kA + kB;
  const float meff = (hit > 0.5f && kn > 1e-12f) ? 1.0f / clamp_min(kn, 1e-12f) : 0.0f;

  const float v0x = ow[3], v0y = ow[4], v0z = ow[5];
  const float w0x = ow[6], w0y = ow[7], w0z = ow[8];
  const float wBx = bf(16), wBy = bf(17), wBz = bf(18);
  const float vAx = v0x + (w0y * rAz - w0z * rAy);
  const float vAy = v0y + (w0z * rAx - w0x * rAz);
  const float vAz = v0z + (w0x * rAy - w0y * rAx);
  const float vBx = live * (bf(13) + (wBy * rBz - wBz * rBy));
  const float vBy = live * (bf(14) + (wBz * rBx - wBx * rBz));
  const float vBz = live * (bf(15) + (wBx * rBy - wBy * rBx));
  const float vn0 = ((vAx - vBx) * nx + (vAy - vBy) * ny) + (vAz - vBz) * nz;
  const float bounce = neg_rest * clamp_max(vn0 + bounce_thr, 0.0f);
  float bias = bias_coef * clamp_min(clamp_min(dep, 0.0f) - slop, 0.0f);
  const float sleeper = stat * (1.0f - ground);
  bias = bias * (1.0f - sleeper);

  const size_t o3 = row * 3 * C + c, o2 = row * 2 * C + c;
  rA[o3] = rAx; rA[o3 + C] = rAy; rA[o3 + 2 * C] = rAz;
  rB[o3] = rBx; rB[o3 + C] = rBy; rB[o3 + 2 * C] = rBz;
  nrm[o3] = nx; nrm[o3 + C] = ny; nrm[o3 + 2 * C] = nz;
  mt[o2] = meff; mt[o2 + C] = maximum(bounce, bias);
  hs[o2] = hit; hs[o2 + C] = stat;
  vn0_out[row * C + c] = vn0;
}

// Field f of body p's partner fields [x | inv_m | inv_I | v0 | w0 | asleep]
// (prep_kernel's staging loops keep these reads inline, as above).
__device__ __forceinline__ float partner_field(int p, int f, const float* __restrict__ x,
                                               const float* __restrict__ v0,
                                               const float* __restrict__ w0,
                                               const float* __restrict__ invm,
                                               const float* __restrict__ invI,
                                               const uint8_t* __restrict__ asleep) {
  if (f < 3) return x[p * 3 + f];
  if (f == 3) return invm[p];
  if (f < 13) return invI[p * 9 + (f - 4)];
  if (f < 16) return v0[p * 3 + (f - 13)];
  if (f < 19) return w0[p * 3 + (f - 16)];
  return asleep[p] ? 1.0f : 0.0f;
}

// Field f of body i's own fields [x | v0 | w0 | inv_m | inv_I].
__device__ __forceinline__ float own_field(int i, int f, const float* __restrict__ x,
                                           const float* __restrict__ v0,
                                           const float* __restrict__ w0,
                                           const float* __restrict__ invm,
                                           const float* __restrict__ invI) {
  if (f < 3) return x[i * 3 + f];
  if (f < 6) return v0[i * 3 + (f - 3)];
  if (f < 9) return w0[i * 3 + (f - 6)];
  if (f == 9) return invm[i];
  return invI[i * 9 + (f - 10)];
}

// The shared variant: RB rows a block, staged in shared memory.
__global__ void __launch_bounds__(THREADS) prep_kernel(
    const float* __restrict__ raw, const int* __restrict__ pidx, const float* __restrict__ gpts,
    const float* __restrict__ gd, int gd_stride, const uint8_t* __restrict__ ghit,
    const float* __restrict__ x, const float* __restrict__ v0, const float* __restrict__ w0,
    const float* __restrict__ invm, const float* __restrict__ invI,
    const uint8_t* __restrict__ asleep, float* __restrict__ rA, float* __restrict__ rB,
    float* __restrict__ nrm, float* __restrict__ mt, float* __restrict__ hs,
    float* __restrict__ scale, float* __restrict__ iAI, float* __restrict__ vn0_out, int Np,
    int K, int M, int G, int RB, float slop, float bias_coef, float neg_rest,
    float bounce_thr) {
  extern __shared__ float smem_rows[];
  const int C = K * M + G, KM = K * M, R = 5 + 6 * M;
  float* const sm = smem_rows;
  const int row0 = blockIdx.x * RB;
  const int nr = min(RB, Np - row0);
  float* srec = sm;                   // RB x K x R   the rows' records
  float* spart = srec + RB * K * R;   // RB x K x PS  partner fields
  float* sown = spart + RB * K * PS;  // RB x 19      [x | v0 | w0 | inv_m | inv_I]
  float* sgp = sown + RB * 19;        // RB x G x 3   ground points
  float* sgd = sgp + RB * G * 3;      // RB x G       ground depths
  float* sgh = sgd + RB * G;          // RB x G       ground hits
  float* shit = sgh + RB * G;         // RB x C       slot hits

  const int tid = threadIdx.x;
  const float* rsrc = raw + (size_t)row0 * K * R;
  for (int j = tid; j < nr * K * R; j += THREADS) srec[j] = rsrc[j];
  for (int j = tid; j < nr * K * 20; j += THREADS) {
    const int rk = j / 20, f = j - rk * 20;
    const int p = min(max(pidx[(size_t)row0 * K + rk], 0), Np - 1);
    float val;
    if (f < 3) val = x[p * 3 + f];
    else if (f == 3) val = invm[p];
    else if (f < 13) val = invI[p * 9 + (f - 4)];
    else if (f < 16) val = v0[p * 3 + (f - 13)];
    else if (f < 19) val = w0[p * 3 + (f - 16)];
    else val = asleep[p] ? 1.0f : 0.0f;
    spart[rk * PS + f] = val;
  }
  for (int j = tid; j < nr * 19; j += THREADS) {
    const int r = j / 19, f = j - r * 19, i = row0 + r;
    float val;
    if (f < 3) val = x[i * 3 + f];
    else if (f < 6) val = v0[i * 3 + (f - 3)];
    else if (f < 9) val = w0[i * 3 + (f - 6)];
    else if (f == 9) val = invm[i];
    else val = invI[i * 9 + (f - 10)];
    sown[j] = val;
  }
  for (int j = tid; j < nr * G * 3; j += THREADS) sgp[j] = gpts[(size_t)row0 * G * 3 + j];
  for (int j = tid; j < nr * G; j += THREADS) {
    const int r = j / G, g = j - r * G;
    sgd[j] = gd[(size_t)(row0 + r) * gd_stride + g];
    sgh[j] = ghit[(size_t)row0 * G + j] ? 1.0f : 0.0f;
  }
  __syncthreads();

  for (int item = tid; item < nr * C; item += THREADS) {
    const int r = item / C, c = item - r * C;
    const size_t row = (size_t)(row0 + r);
    const bool pair = c < KM;
    const int k = pair ? c % K : 0;
    const float ground = pair ? 0.0f : 1.0f;
    const float* ow = sown + r * 19;
    const float* pf = spart + (r * K + k) * PS;
    // Partner fields tile over the M manifold slots; ground slots read 0.
    auto bf = [&](int field) { return pair ? pf[field] : 0.0f; };
    float nx, ny, nz, px, py, pz, dep, hit;
    if (pair) {
      const float* rec = srec + (r * K + k) * R;
      const int mo = 6 * (c / K);
      nx = rec[0]; ny = rec[1]; nz = rec[2];
      dep = rec[5 + mo]; hit = rec[6 + mo];
      px = rec[7 + mo]; py = rec[8 + mo]; pz = rec[9 + mo];
    } else {
      const int g = r * G + (c - KM);
      nx = 0.0f; ny = 0.0f; nz = 0.0f;
      px = sgp[g * 3 + 0]; py = sgp[g * 3 + 1]; pz = sgp[g * 3 + 2];
      dep = sgd[g]; hit = sgh[g];
    }
    dep = clamp_min(dep, 0.0f);  // the slot table's depth
    ny = ny + ground;
    const float stat = clamp_max(bf(19) + ground, 1.0f);
    const float live = 1.0f - stat;

    const float ox = ow[0], oy = ow[1], oz = ow[2];
    const float rAx = px - ox, rAy = py - oy, rAz = pz - oz;
    const float rBx = px - bf(0), rBy = py - bf(1), rBz = pz - bf(2);

    const float cAx = rAy * nz - rAz * ny;
    const float cAy = rAz * nx - rAx * nz;
    const float cAz = rAx * ny - rAy * nx;
    const float tAx = (ow[10] * cAx + ow[11] * cAy) + ow[12] * cAz;
    const float tAy = (ow[13] * cAx + ow[14] * cAy) + ow[15] * cAz;
    const float tAz = (ow[16] * cAx + ow[17] * cAy) + ow[18] * cAz;
    const float kA = ((ow[9] + cAx * tAx) + cAy * tAy) + cAz * tAz;
    const float cBx = rBy * nz - rBz * ny;
    const float cBy = rBz * nx - rBx * nz;
    const float cBz = rBx * ny - rBy * nx;
    const float tBx = (bf(4) * cBx + bf(5) * cBy) + bf(6) * cBz;
    const float tBy = (bf(7) * cBx + bf(8) * cBy) + bf(9) * cBz;
    const float tBz = (bf(10) * cBx + bf(11) * cBy) + bf(12) * cBz;
    const float kB = live * (((bf(3) + cBx * tBx) + cBy * tBy) + cBz * tBz);
    const float kn = kA + kB;
    const float meff = (hit > 0.5f && kn > 1e-12f) ? 1.0f / clamp_min(kn, 1e-12f) : 0.0f;

    const float v0x = ow[3], v0y = ow[4], v0z = ow[5];
    const float w0x = ow[6], w0y = ow[7], w0z = ow[8];
    const float wBx = bf(16), wBy = bf(17), wBz = bf(18);
    const float vAx = v0x + (w0y * rAz - w0z * rAy);
    const float vAy = v0y + (w0z * rAx - w0x * rAz);
    const float vAz = v0z + (w0x * rAy - w0y * rAx);
    const float vBx = live * (bf(13) + (wBy * rBz - wBz * rBy));
    const float vBy = live * (bf(14) + (wBz * rBx - wBx * rBz));
    const float vBz = live * (bf(15) + (wBx * rBy - wBy * rBx));
    const float vn0 = ((vAx - vBx) * nx + (vAy - vBy) * ny) + (vAz - vBz) * nz;
    const float bounce = neg_rest * clamp_max(vn0 + bounce_thr, 0.0f);
    float bias = bias_coef * clamp_min(clamp_min(dep, 0.0f) - slop, 0.0f);
    const float sleeper = stat * (1.0f - ground);
    bias = bias * (1.0f - sleeper);

    const size_t o3 = row * 3 * C + c, o2 = row * 2 * C + c;
    rA[o3] = rAx; rA[o3 + C] = rAy; rA[o3 + 2 * C] = rAz;
    rB[o3] = rBx; rB[o3 + C] = rBy; rB[o3 + 2 * C] = rBz;
    nrm[o3] = nx; nrm[o3 + C] = ny; nrm[o3 + 2 * C] = nz;
    mt[o2] = meff; mt[o2 + C] = maximum(bounce, bias);
    hs[o2] = hit; hs[o2 + C] = stat;
    vn0_out[row * C + c] = vn0;
    shit[item] = hit;
  }
  __syncthreads();

  for (int r = tid; r < nr; r += THREADS) {
    float cnt = 0.0f;
    for (int c = 0; c < C; ++c) cnt = cnt + shit[r * C + c];
    const float split = 1.0f / clamp_min(cnt, 1.0f);
    scale[(size_t)(row0 + r) * 2 + 0] = sown[r * 19 + 9] * split;
    scale[(size_t)(row0 + r) * 2 + 1] = split;
  }
  for (int j = tid; j < nr * 9; j += THREADS) {
    const int r = j / 9;
    iAI[(size_t)row0 * 9 + j] = sown[r * 19 + 10 + (j - r * 9)];
  }
}

// Partners a pass of the wide variant takes (at most K; 0 when one does not
// fit) and the floats of shared memory they stage: PS fields each and, with
// STAGE, R record floats each and 4 of room to align the records' copy.
__host__ __device__ inline int wide_partners(int K, int M, bool stage) {
  const int per = (stage ? 5 + 6 * M : 0) + PS;
  const int kc = (WIDE_ROOM / 4 - (stage ? 4 : 0)) / per;
  return kc < K ? kc : K;
}

__host__ __device__ inline int wide_floats(int K, int M, bool stage) {
  return wide_partners(K, M, stage) * ((stage ? 5 + 6 * M : 0) + PS) + (stage ? 4 : 0);
}

// The wide variant: one CTA a row; passes of KC partners (their fields, and
// with STAGE their records, in shared memory), then the ground slots read in
// place; the hit count a block vote. Every thread runs every pass, so the
// votes see the whole block.
template <bool STAGE>
__global__ void __launch_bounds__(THREADS) prep_wide_kernel(
    const float* __restrict__ raw, const int* __restrict__ pidx, const float* __restrict__ gpts,
    const float* __restrict__ gd, int gd_stride, const uint8_t* __restrict__ ghit,
    const float* __restrict__ x, const float* __restrict__ v0, const float* __restrict__ w0,
    const float* __restrict__ invm, const float* __restrict__ invI,
    const uint8_t* __restrict__ asleep, float* __restrict__ rA, float* __restrict__ rB,
    float* __restrict__ nrm, float* __restrict__ mt, float* __restrict__ hs,
    float* __restrict__ scale, float* __restrict__ iAI, float* __restrict__ vn0_out, int Np,
    int K, int M, int G, int KC, float slop, float bias_coef, float neg_rest,
    float bounce_thr) {
  extern __shared__ __align__(16) float wide_smem[];
  __shared__ float sown[19];
  const int C = K * M + G, KM = K * M, R = 5 + 6 * M;
  const int tid = threadIdx.x;
  const int i = blockIdx.x;
  const size_t row = (size_t)i;
  float* const srec = wide_smem;                                // KC x R (+ 4), STAGE
  float* const spart = wide_smem + (STAGE ? KC * R + 4 : 0);    // KC x PS
  if (tid < 19) sown[tid] = own_field(i, tid, x, v0, w0, invm, invI);
  __syncthreads();
  int cnt = 0;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();                    // the last pass's reads are done
    for (int j = tid; j < kc * 20; j += THREADS) {
      const int kk = j / 20, f = j - kk * 20;
      const int p = min(max(pidx[row * K + k0 + kk], 0), Np - 1);
      spart[kk * PS + f] = partner_field(p, f, x, v0, w0, invm, invI, asleep);
    }
    const float* rec0 = raw + (row * K + k0) * R;
    if constexpr (STAGE) {   // 16-byte copies, the copy aligned as its source
      const int n = kc * R;
      const int a = (int)((reinterpret_cast<uintptr_t>(rec0) >> 2) & 3);
      float* dst = srec + a;
      const int head = min(n, (4 - a) & 3);
      if (tid < head) dst[tid] = rec0[tid];
      const int n4 = (n - head) >> 2;
      const float4* s4 = reinterpret_cast<const float4*>(rec0 + head);
      float4* d4 = reinterpret_cast<float4*>(dst + head);
      for (int j = tid; j < n4; j += THREADS) d4[j] = s4[j];
      for (int j = head + 4 * n4 + tid; j < n; j += THREADS) dst[j] = rec0[j];
      rec0 = dst;
    }
    __syncthreads();
    const int n = M * kc;
    for (int base = 0; base < n; base += THREADS) {
      const int item = base + tid;
      bool h = false;
      if (item < n) {
        const int m = item / kc, kk = item - m * kc;
        const float* rec = rec0 + (size_t)kk * R;
        const int mo = 6 * m;
        const float hit = rec[6 + mo];
        slot_tables(sown, spart + kk * PS, true, rec[0], rec[1], rec[2], rec[7 + mo],
                    rec[8 + mo], rec[9 + mo], rec[5 + mo], hit, row, C, m * K + k0 + kk, rA, rB,
                    nrm, mt, hs, vn0_out, slop, bias_coef, neg_rest, bounce_thr);
        h = hit > 0.5f;
      }
      cnt += __syncthreads_count(h);
    }
  }
  for (int base = 0; base < G; base += THREADS) {
    const int g = base + tid;
    bool h = false;
    if (g < G) {
      const float* gp = gpts + (row * G + g) * 3;
      const float hit = ghit[row * G + g] ? 1.0f : 0.0f;
      slot_tables(sown, spart, false, 0.0f, 0.0f, 0.0f, gp[0], gp[1], gp[2],
                  gd[row * gd_stride + g], hit, row, C, KM + g, rA, rB, nrm, mt, hs, vn0_out,
                  slop, bias_coef, neg_rest, bounce_thr);
      h = hit > 0.5f;
    }
    cnt += __syncthreads_count(h);
  }
  if (tid == 0) {
    const float split = 1.0f / clamp_min((float)cnt, 1.0f);
    scale[row * 2 + 0] = sown[9] * split;
    scale[row * 2 + 1] = split;
  }
  if (tid < 9) iAI[row * 9 + tid] = sown[10 + tid];
}

// Rows a block takes and the shared bytes they need: RB·C close to the
// block's 256 threads, within the 48 KB a launch may take without opting in;
// 0 rows if one row does not fit (the wide variant takes those shapes).
int rows_per_block(int K, int M, int G, size_t* smem) {
  const int C = K * M + G;
  const size_t per_row = (size_t)row_floats(K, M, G) * sizeof(float);
  int rb = C > 0 ? THREADS / C : THREADS;
  if (rb < 1) rb = 1;
  while (rb > 0 && (size_t)rb * per_row > 48 * 1024) --rb;
  *smem = (size_t)rb * per_row;
  return rb;
}

constexpr int MAX_DEVICES = 64;
int wide_smem_set[2][MAX_DEVICES] = {};   // prep_wide_kernel<false>, <true>

}  // namespace

extern "C" long long surtr_prep_row_bytes(int K, int M, int G) {
  return (long long)row_floats(K, M, G) * sizeof(float);
}

// Shared bytes of the wide variant's CTA, records staged (stage 1) or not.
extern "C" long long surtr_prep_wide_bytes(int K, int M, int stage) {
  return (long long)wide_floats(K, M, stage != 0) * sizeof(float);
}

// variant: 0 the shared variant (a row within 48 KB), 1 the wide variant
// with its records staged, 2 with its records read in place; one launch.
extern "C" int surtr_prep(const float* raw, const int* pidx, const float* gpts, const float* gd,
                          int gd_stride, const uint8_t* ghit, const float* x, const float* v0,
                          const float* w0, const float* invm, const float* invI,
                          const uint8_t* asleep, float* rA, float* rB, float* nrm, float* mt,
                          float* hs, float* scale, float* iAI, float* vn0, int Np, int K, int M,
                          int G, float slop, float bias_coef, float neg_rest, float bounce_thr,
                          int variant, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Np <= 0) return (int)cudaGetLastError();
  if (variant == 0) {
    size_t smem;
    const int rb = rows_per_block(K, M, G, &smem);
    if (rb <= 0) return (int)cudaErrorInvalidValue;
    prep_kernel<<<(Np + rb - 1) / rb, THREADS, smem, st>>>(
        raw, pidx, gpts, gd, gd_stride, ghit, x, v0, w0, invm, invI, asleep, rA, rB, nrm, mt,
        hs, scale, iAI, vn0, Np, K, M, G, rb, slop, bias_coef, neg_rest, bounce_thr);
    return (int)cudaGetLastError();
  }
  if (variant != 1 && variant != 2) return (int)cudaErrorInvalidValue;
  const bool stage = variant == 1;
  const int kc = wide_partners(K, M, stage);
  if (kc < 1 && K > 0) return (int)cudaErrorInvalidValue;
  const int smem = wide_floats(K, M, stage) * (int)sizeof(float);
  auto kernel = stage ? prep_wide_kernel<true> : prep_wide_kernel<false>;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    int& set = wide_smem_set[stage][dev];
    if (smem > set) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      set = smem;
    }
  }
  kernel<<<Np, THREADS, smem, st>>>(raw, pidx, gpts, gd, gd_stride, ghit, x, v0, w0, invm, invI,
                                    asleep, rA, rB, nrm, mt, hs, scale, iAI, vn0, Np, K, M, G,
                                    kc < 1 ? 1 : kc, slop, bias_coef, neg_rest, bounce_thr);
  return (int)cudaGetLastError();
}
