// Contact prep for the single-piece solver (kernel B8).
//
// Replaces: surtr_tpu/physics/prep_pallas.py `_prep_kernel` (wrapper
// `prep_contacts_pallas`). Semantics of the plain version in
// surtr_tpu_torch/physics/prep_cuda.py `prep_contacts_reference`: per body
// row and contact slot (C = K·M + G, slot m·K + k reads pair k, then G
// ground slots with normal +y and a static partner), the lever arms rA, rB;
// kA = inv_m + (rA x n).I⁻¹(rA x n) and kB likewise for a live partner;
// m_eff = 1/max(kA + kB, 1e-12) on hit slots; vn0 = (vA0 - vB0).n; the
// target max(-e·min(vn0 + thr, 0), (β/dt)·max(max(d, 0) - slop, 0)) with no
// bias against a sleeping partner; per row the mass-splitting scale
// 1/max(#hits, 1). The partner fields arrive gathered per pair (`btf`, a
// PyTorch gather in the step's glue).
//
// What bounds it on the card: bytes. Per row it reads (3C + 2C + 3K + 20K
// + 19) floats and writes (13C + 11) floats: 2.6 KB at K = 8, M = 4, G = 4,
// C = 36, with ~80 flops a slot; 26 MB at 10k rows, about 8 us at
// 3.35 TB/s. Design: one thread per row, the C slots in a loop, all
// arithmetic in registers; reads and writes are row-strided across a warp
// and lean on L1/L2 to merge lines. The division and comparisons are IEEE
// (no fast math) and -fmad=false keeps every rounding of the plain version.

#include <cuda_runtime.h>

namespace {

__global__ void prep_kernel(const float* __restrict__ pt3, const float* __restrict__ dh,
                            const float* __restrict__ pn3, const float* __restrict__ btf,
                            const float* __restrict__ own, float* __restrict__ rA,
                            float* __restrict__ rB, float* __restrict__ nrm,
                            float* __restrict__ mt, float* __restrict__ hs,
                            float* __restrict__ scale, float* __restrict__ iAI,
                            float* __restrict__ vn0_out, int Np, int K, int M, int G, float slop,
                            float bias_coef, float neg_rest, float bounce_thr) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= Np) return;
  const int C = K * M + G, KM = K * M;
  const float* pt = pt3 + (size_t)row * 3 * C;
  const float* d = dh + (size_t)row * 2 * C;
  const float* pn = pn3 + (size_t)row * 3 * K;
  const float* bt = btf + (size_t)row * 20 * K;
  const float* ow = own + (size_t)row * 19;
  const float ox = ow[0], oy = ow[1], oz = ow[2];
  const float v0x = ow[3], v0y = ow[4], v0z = ow[5];
  const float w0x = ow[6], w0y = ow[7], w0z = ow[8];
  const float invm = ow[9];
  float II[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) II[t] = ow[10 + t];

  float* orA = rA + (size_t)row * 3 * C;
  float* orB = rB + (size_t)row * 3 * C;
  float* on = nrm + (size_t)row * 3 * C;
  float* omt = mt + (size_t)row * 2 * C;
  float* ohs = hs + (size_t)row * 2 * C;
  float* ovn = vn0_out + (size_t)row * C;
  float cnt = 0.0f;
  for (int c = 0; c < C; ++c) {
    const bool pair = c < KM;
    const int k = c % K;
    const float ground = pair ? 0.0f : 1.0f;
    // Per-pair fields tile over the M manifold slots; ground slots read 0.
    auto bf = [&](int field) { return pair ? bt[field * K + k] : 0.0f; };
    const float nx = pair ? pn[k] : 0.0f;
    const float ny = (pair ? pn[K + k] : 0.0f) + ground;
    const float nz = pair ? pn[2 * K + k] : 0.0f;
    const float px = pt[c], py = pt[C + c], pz = pt[2 * C + c];
    const float dep = d[c], hit = d[C + c];
    const float stat = fminf(bf(19) + ground, 1.0f);
    const float live = 1.0f - stat;

    const float rAx = px - ox, rAy = py - oy, rAz = pz - oz;
    const float rBx = px - bf(0), rBy = py - bf(1), rBz = pz - bf(2);

    const float cAx = rAy * nz - rAz * ny;
    const float cAy = rAz * nx - rAx * nz;
    const float cAz = rAx * ny - rAy * nx;
    const float tAx = (II[0] * cAx + II[1] * cAy) + II[2] * cAz;
    const float tAy = (II[3] * cAx + II[4] * cAy) + II[5] * cAz;
    const float tAz = (II[6] * cAx + II[7] * cAy) + II[8] * cAz;
    const float kA = ((invm + cAx * tAx) + cAy * tAy) + cAz * tAz;
    const float cBx = rBy * nz - rBz * ny;
    const float cBy = rBz * nx - rBx * nz;
    const float cBz = rBx * ny - rBy * nx;
    const float tBx = (bf(4) * cBx + bf(5) * cBy) + bf(6) * cBz;
    const float tBy = (bf(7) * cBx + bf(8) * cBy) + bf(9) * cBz;
    const float tBz = (bf(10) * cBx + bf(11) * cBy) + bf(12) * cBz;
    const float kB = live * (((bf(3) + cBx * tBx) + cBy * tBy) + cBz * tBz);
    const float kn = kA + kB;
    const float meff = (hit > 0.5f && kn > 1e-12f) ? 1.0f / fmaxf(kn, 1e-12f) : 0.0f;

    const float wBx = bf(16), wBy = bf(17), wBz = bf(18);
    const float vAx = v0x + (w0y * rAz - w0z * rAy);
    const float vAy = v0y + (w0z * rAx - w0x * rAz);
    const float vAz = v0z + (w0x * rAy - w0y * rAx);
    const float vBx = live * (bf(13) + (wBy * rBz - wBz * rBy));
    const float vBy = live * (bf(14) + (wBz * rBx - wBx * rBz));
    const float vBz = live * (bf(15) + (wBx * rBy - wBy * rBx));
    const float vn0 = ((vAx - vBx) * nx + (vAy - vBy) * ny) + (vAz - vBz) * nz;
    const float bounce = neg_rest * fminf(vn0 + bounce_thr, 0.0f);
    float bias = bias_coef * fmaxf(fmaxf(dep, 0.0f) - slop, 0.0f);
    const float sleeper = stat * (1.0f - ground);
    bias = bias * (1.0f - sleeper);

    orA[c] = rAx; orA[C + c] = rAy; orA[2 * C + c] = rAz;
    orB[c] = rBx; orB[C + c] = rBy; orB[2 * C + c] = rBz;
    on[c] = nx; on[C + c] = ny; on[2 * C + c] = nz;
    omt[c] = meff; omt[C + c] = fmaxf(bounce, bias);
    ohs[c] = hit; ohs[C + c] = stat;
    ovn[c] = vn0;
    cnt = cnt + hit;
  }
  const float split = 1.0f / fmaxf(cnt, 1.0f);
  scale[(size_t)row * 2 + 0] = invm * split;
  scale[(size_t)row * 2 + 1] = split;
#pragma unroll
  for (int t = 0; t < 9; ++t) iAI[(size_t)row * 9 + t] = II[t];
}

}  // namespace

extern "C" int surtr_prep(const float* pt3, const float* dh, const float* pn3, const float* btf,
                          const float* own, float* rA, float* rB, float* nrm, float* mt,
                          float* hs, float* scale, float* iAI, float* vn0, int Np, int K, int M,
                          int G, float slop, float bias_coef, float neg_rest, float bounce_thr,
                          void* stream) {
  const int threads = 128;
  if (Np > 0)
    prep_kernel<<<(Np + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        pt3, dh, pn3, btf, own, rA, rB, nrm, mt, hs, scale, iAI, vn0, Np, K, M, G, slop,
        bias_coef, neg_rest, bounce_thr);
  return (int)cudaGetLastError();
}
