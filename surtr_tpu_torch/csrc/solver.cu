// One outer iteration of the single-piece contact solver (kernel B9).
//
// Replaces: surtr_tpu/physics/solver_pallas.py `_solver_iter_kernel`
// (wrapper `solve_packed`), both modes. Semantics of the plain versions in
// surtr_tpu_torch/physics/solver_cuda.py `solver_iteration_reference` and,
// for the accumulated (warm-start) mode, `solver_iteration_warm_reference`
// (entry point surtr_solver_iter_warm: the per-slot accumulators
// [λn | λu | λv] come in and go out as a second pair of ping-pong buffers,
// and the clamps act on the totals): per body row, partner velocities vB per
// slot from the previous iteration's state (slot m·K + k reads pair k;
// ground and static slots get 0); then S substeps, each computing on every
// slot the relative velocity, the normal impulse max(-(vn - target)·m_eff, 0)
// and the friction impulse min(|vt|·m_eff, mu·λn) against the tangential
// direction, summing impulse and torque over the C slots in slot order, and
// updating v += (inv_m·split)·Σλ, w += split·I⁻¹·Σ(rA x λ). Last, the wake
// flag takes the max of its own value and hit·live·(partner wake).
//
// What bounds it on the card: bytes. Per row one launch reads the tables
// (11C + 11 floats, 1.6 KB at C = 36) and K partner states, and writes
// 32 B; ~95 flops a slot and substep. At 10k rows: ~16 MB and ~70 MFLOP a
// launch, about 5 us at 3.35 TB/s; the step makes 4 launches. The warm
// mode adds 3C floats in and out a row (~0.9 KB) and ~45 flops a slot.
// Design: one thread per row. The TPU version needed the partner gather in
// XLA between launches; here the kernel reads the partner rows by index
// itself, from the input state buffer, and writes the next state to a
// second buffer, so blocks running in any order see only the previous
// iteration (ping-pong across the 4 launches). Sums run in slot order
// starting from 0, as the plain version's, and -fmad=false keeps each
// rounding, so kernel and plain agree to the last bit on the same inputs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// The deterministic tangent basis of solver_cuda.tangent_basis: u =
// normalize(e x n) with e the axis of n's smallest |component| (first of
// ties), v = n x u.
__device__ inline void tangent_basis(float nx, float ny, float nz, float& ux, float& uy,
                                     float& uz, float& vx, float& vy, float& vz) {
  const float ax = fabsf(nx), ay = fabsf(ny), az = fabsf(nz);
  const float ex = (ax <= ay && ax <= az) ? 1.0f : 0.0f;
  const float ey = (ay < ax && ay <= az) ? 1.0f : 0.0f;
  const float ez = (1.0f - ex) - ey;
  ux = ey * nz - ez * ny;
  uy = ez * nx - ex * nz;
  uz = ex * ny - ey * nx;
  const float ul = sqrtf((ux * ux + uy * uy) + uz * uz);
  const float inv = 1.0f / fmaxf(ul, 1e-12f);
  ux = ux * inv;
  uy = uy * inv;
  uz = uz * inv;
  vx = ny * uz - nz * uy;
  vy = nz * ux - nx * uz;
  vz = nx * uy - ny * ux;
}

template <bool WARM>
__global__ void solver_iter_kernel(const float* __restrict__ vw, const int* __restrict__ pb,
                                   const float* __restrict__ rA, const float* __restrict__ rB,
                                   const float* __restrict__ nrm, const float* __restrict__ mt,
                                   const float* __restrict__ hs, const float* __restrict__ scale,
                                   const float* __restrict__ iAI, const float* __restrict__ lam,
                                   float* __restrict__ vw_out, float* __restrict__ lam_out,
                                   int Np, int K, int M, int G, int S, float mu) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= Np) return;
  const int C = K * M + G, KM = K * M;
  const float* a = rA + (size_t)row * 3 * C;
  const float* b = rB + (size_t)row * 3 * C;
  const float* n = nrm + (size_t)row * 3 * C;
  const float* t = mt + (size_t)row * 2 * C;
  const float* h = hs + (size_t)row * 2 * C;
  const int* partner = pb + (size_t)row * K;
  const float m_s = scale[(size_t)row * 2 + 0], s_s = scale[(size_t)row * 2 + 1];
  float II[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) II[q] = iAI[(size_t)row * 9 + q];
  const float* own = vw + (size_t)row * 8;
  float v0 = own[0], v1 = own[1], v2 = own[2];
  float w0 = own[3], w1 = own[4], w2 = own[5];
  // Warm mode: the row's accumulators live in the output buffer, copied
  // from the input first (lam and lam_out are two buffers, ping-ponged).
  float* la = WARM ? lam_out + (size_t)row * 3 * C : nullptr;
  if (WARM) {
    const float* li = lam + (size_t)row * 3 * C;
    for (int q = 0; q < 3 * C; ++q) la[q] = li[q];
  }

  for (int s = 0; s < S; ++s) {
    float sx = 0.f, sy = 0.f, sz = 0.f, tqx = 0.f, tqy = 0.f, tqz = 0.f;
    for (int c = 0; c < C; ++c) {
      const float rAx = a[c], rAy = a[C + c], rAz = a[2 * C + c];
      const float rBx = b[c], rBy = b[C + c], rBz = b[2 * C + c];
      const float nx = n[c], ny = n[C + c], nz = n[2 * C + c];
      const float meff = t[c], targ = t[C + c];
      const float hit = h[c], live = 1.0f - h[C + c];
      float pv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (c < KM) {
        const float* q = vw + (size_t)partner[c % K] * 8;
#pragma unroll
        for (int r = 0; r < 6; ++r) pv[r] = q[r];
      }
      const float vBx = live * (pv[0] + (pv[4] * rBz - pv[5] * rBy));
      const float vBy = live * (pv[1] + (pv[5] * rBx - pv[3] * rBz));
      const float vBz = live * (pv[2] + (pv[3] * rBy - pv[4] * rBx));
      const float vrx = (v0 + (w1 * rAz - w2 * rAy)) - vBx;
      const float vry = (v1 + (w2 * rAx - w0 * rAz)) - vBy;
      const float vrz = (v2 + (w0 * rAy - w1 * rAx)) - vBz;
      const float vn = (vrx * nx + vry * ny) + vrz * nz;
      float ix, iy, iz;
      if (WARM) {
        // Accumulated impulses: the clamps act on the totals [λn | λu | λv],
        // friction as a 2-D vector in the tangent basis, cone-clamped by
        // rescaling against mu·λn.
        float ux, uy, uz, wx, wy, wz;
        tangent_basis(nx, ny, nz, ux, uy, uz, wx, wy, wz);
        const float acc_n = la[c], acc_u = la[C + c], acc_v = la[2 * C + c];
        const float dlam = -(vn - targ) * meff;
        const float lam_new = fmaxf(acc_n + dlam, 0.0f) * hit;
        const float lam_n = lam_new - acc_n;
        const float vtu = (vrx * ux + vry * uy) + vrz * uz;
        const float vtv = (vrx * wx + vry * wy) + vrz * wz;
        float lu = (acc_u - vtu * meff) * hit;
        float lv = (acc_v - vtv * meff) * hit;
        const float tl = sqrtf(lu * lu + lv * lv);
        const float cone = mu * lam_new;
        const float scl = tl > cone ? cone / fmaxf(tl, 1e-12f) : 1.0f;
        lu = lu * scl;
        lv = lv * scl;
        const float imp_u = lu - acc_u, imp_v = lv - acc_v;
        la[c] = lam_new;
        la[C + c] = lu;
        la[2 * C + c] = lv;
        ix = hit * ((lam_n * nx + imp_u * ux) + imp_v * wx);
        iy = hit * ((lam_n * ny + imp_u * uy) + imp_v * wy);
        iz = hit * ((lam_n * nz + imp_u * uz) + imp_v * wz);
      } else {
        const float vtx = vrx - vn * nx;
        const float vty = vry - vn * ny;
        const float vtz = vrz - vn * nz;
        const float vt_len = sqrtf((vtx * vtx + vty * vty) + vtz * vtz);
        const float inv_vt = 1.0f / fmaxf(vt_len, 1e-9f);
        const float lam_n = fmaxf(-(vn - targ) * meff, 0.0f);
        const float lam_t = fminf(vt_len * meff, mu * lam_n);
        ix = hit * (lam_n * nx - lam_t * vtx * inv_vt);
        iy = hit * (lam_n * ny - lam_t * vty * inv_vt);
        iz = hit * (lam_n * nz - lam_t * vtz * inv_vt);
      }
      sx = sx + ix;
      sy = sy + iy;
      sz = sz + iz;
      tqx = tqx + (rAy * iz - rAz * iy);
      tqy = tqy + (rAz * ix - rAx * iz);
      tqz = tqz + (rAx * iy - rAy * ix);
    }
    const float dwx = s_s * ((II[0] * tqx + II[1] * tqy) + II[2] * tqz);
    const float dwy = s_s * ((II[3] * tqx + II[4] * tqy) + II[5] * tqz);
    const float dwz = s_s * ((II[6] * tqx + II[7] * tqy) + II[8] * tqz);
    v0 = v0 + m_s * sx; v1 = v1 + m_s * sy; v2 = v2 + m_s * sz;
    w0 = w0 + dwx; w1 = w1 + dwy; w2 = w2 + dwz;
  }

  float wmax = 0.0f;
  for (int c = 0; c < KM; ++c) {
    const float pw = vw[(size_t)partner[c % K] * 8 + 6];
    wmax = fmaxf(wmax, h[c] * (1.0f - h[C + c]) * pw);
  }
  float* o = vw_out + (size_t)row * 8;
  o[0] = v0; o[1] = v1; o[2] = v2;
  o[3] = w0; o[4] = w1; o[5] = w2;
  o[6] = fmaxf(own[6], wmax);
  o[7] = 0.0f;
}

}  // namespace

extern "C" int surtr_solver_iter(const float* vw, const int* pb, const float* rA,
                                 const float* rB, const float* nrm, const float* mt,
                                 const float* hs, const float* scale, const float* iAI,
                                 float* vw_out, int Np, int K, int M, int G, int S, float mu,
                                 void* stream) {
  const int threads = 128;
  if (Np > 0)
    solver_iter_kernel<false><<<(Np + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        vw, pb, rA, rB, nrm, mt, hs, scale, iAI, nullptr, vw_out, nullptr, Np, K, M, G, S, mu);
  return (int)cudaGetLastError();
}

extern "C" int surtr_solver_iter_warm(const float* vw, const int* pb, const float* rA,
                                      const float* rB, const float* nrm, const float* mt,
                                      const float* hs, const float* scale, const float* iAI,
                                      const float* lam, float* vw_out, float* lam_out, int Np,
                                      int K, int M, int G, int S, float mu, void* stream) {
  const int threads = 128;
  if (Np > 0)
    solver_iter_kernel<true><<<(Np + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        vw, pb, rA, rB, nrm, mt, hs, scale, iAI, lam, vw_out, lam_out, Np, K, M, G, S, mu);
  return (int)cudaGetLastError();
}
