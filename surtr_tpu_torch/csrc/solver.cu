// The single-piece contact solver's outer iterations (kernel B9).
//
// Replaces: surtr_tpu/physics/solver_pallas.py `_solver_iter_kernel`
// (wrapper `solve_packed`), both modes. Semantics of the plain versions in
// surtr_tpu_torch/physics/solver_cuda.py `solver_iteration_reference` and,
// for the accumulated (warm-start) mode, `solver_iteration_warm_reference`
// (the per-slot totals [λn | λu | λv] come in and go out beside the state,
// and the clamps act on the totals). One outer iteration, per body row:
// partner velocities vB per slot from the previous iteration's state (slot
// m·K + k reads pair k; ground and static slots get 0); then S substeps,
// each computing on every slot the relative velocity, the normal impulse
// max(-(vn - target)·m_eff, 0) and the friction impulse min(|vt|·m_eff,
// mu·λn) against the tangential direction, summing impulse and torque over
// the C slots in slot order from 0, and updating v += (inv_m·split)·Σλ,
// w += split·I⁻¹·Σ(rA x λ). Last, the wake flag takes the max of its own
// value and hit·live·(partner wake).
//
// What bounds it on the card: bytes. A row's tables are 13C + 11 floats
// (1.9 KB at C = 36) and it reads K partner states; ~95 flops a slot and
// substep. At the 10k lattice: ~19 MB and ~70 MFLOP an iteration, about
// 6 us at 3.35 TB/s.
//
// The first design ran one thread per row and one launch per iteration:
// 79 CTAs of 4 warps at 10k rows (about 3% of the card's warp slots), each
// thread walking its C slots serially with loads 3C floats apart across a
// warp, gathering a partner state for every pair slot on every substep, and
// the wrapper converting the tables before each of the 4 launches. It took
// 0.32-0.46 ms a step on an NVIDIA H100 80GB HBM3 at 700 W. This design:
//  - lanes over slots: a group of 16 lanes per row, slot c on lane c % 16
//    (SPL = ceil(C / 16) slots a lane, 3 at the lattice); the row's tables
//    load coalesced once per iteration into registers for the S substeps;
//    lanes 0..K-1 gather the K partner states once per iteration and the
//    slots take them by shuffle; vB, and in warm mode the tangent basis and
//    the accumulated totals, stay in registers across the substeps;
//  - sums in slot order: each lane stages its slots' six impulse and
//    torque components in shared memory and six lanes add one component
//    each over the slots from 0 (no tree, the plain version's order); the
//    sums come back by shuffle and every lane updates v and w alike. The
//    wake max is order-free and reduces by shuffle;
//  - one launch a solve: a cooperative kernel whose CTAs walk the rows and
//    meet at a grid-wide barrier between iterations, reading one state
//    buffer and writing the other (ping-pong), so no row sees a partner's
//    update of the same iteration. The wrapper checks and converts the
//    tables once a solve.
// Every product and sum is rounded on its own (built with -fmad=false,
// IEEE division and square root), so the plain version gives the same bits.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/time_b9_b11.py, the
// 10k lattice's 64th step, 4 iterations of 2 substeps; the first design in
// the same call): 0.047 ms a solve on the device in one launch against
// 0.24 ms in four (warm mode 0.050 against 0.34 ms), 0.104-0.106 ms with
// the wrapper's host work against 0.29-0.30 ms.
// Past K = 16 or C = 128 the shared variant below takes a row a warp with
// its tables, partner states and sums in shared memory; only a row past a
// block's shared memory goes to the general variant's device scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GS = 16;                   // lanes of a row's group
constexpr int ROWS = 8;                  // rows of a CTA (4 warps of 2 groups)
constexpr int THREADS = GS * ROWS;

// The deterministic tangent basis of slots.tangent_basis: u = normalize(e x
// n) with e the axis of n's smallest |component| (first of ties), v = n x u.
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

struct Params {
  const float* vw0;   // (Np, 8) state in
  const int* pb;      // (Np, K) partner rows
  const float *rA, *rB, *nrm, *mt, *hs, *scale, *iAI;  // B8's tables
  const float* lam0;  // (Np, 3C) totals in (warm mode)
  float* vw_buf;      // (2, Np, 8): iteration i writes buffer i % 2
  float* lam_buf;     // (2, Np, 3C) (warm mode)
  int Np, K, M, G, S, outer;
  float mu;
};

__device__ inline float gshfl(float v, int src) { return __shfl_sync(0xffffffffu, v, src, GS); }

template <int SPL, bool WARM>
__device__ void solve_row(const Params& p, int row, bool store, int lane, float* st,
                          const float* vin, float* vout, const float* lin, float* lout) {
  const int C = p.K * p.M + p.G, KM = p.K * p.M;
  constexpr int CS = SPL * GS + 1;  // odd stride: the six summing lanes hit six banks
  const size_t r3 = (size_t)row * 3 * C, r2 = (size_t)row * 2 * C;
  const float* own = vin + (size_t)row * 8;
  float v0 = own[0], v1 = own[1], v2 = own[2];
  float w0 = own[3], w1 = own[4], w2 = own[5];
  const float wake_own = own[6];
  const float m_s = p.scale[(size_t)row * 2 + 0], s_s = p.scale[(size_t)row * 2 + 1];
  float II[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) II[q] = p.iAI[(size_t)row * 9 + q];

  // Lanes 0..K-1 gather the K partner states once.
  float pst[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (lane < p.K) {
    const float* q = vin + (size_t)p.pb[(size_t)row * p.K + lane] * 8;
#pragma unroll
    for (int r = 0; r < 7; ++r) pst[r] = q[r];
  }

  float rAx[SPL], rAy[SPL], rAz[SPL], nx[SPL], ny[SPL], nz[SPL];
  float meff[SPL], targ[SPL], hit[SPL], vBx[SPL], vBy[SPL], vBz[SPL];
  float an[SPL], au[SPL], av[SPL], ux[SPL], uy[SPL], uz[SPL], tx[SPL], ty[SPL], tz[SPL];
  float wmax = 0.0f;
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const int c = lane + GS * q;
    const bool ok = c < C;
    const bool pair = c < KM;
    const int src = pair ? c % p.K : 0;
    float pv[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      const float x = gshfl(pst[r], src);
      pv[r] = pair ? x : 0.0f;
    }
    rAx[q] = ok ? p.rA[r3 + c] : 0.f;
    rAy[q] = ok ? p.rA[r3 + C + c] : 0.f;
    rAz[q] = ok ? p.rA[r3 + 2 * C + c] : 0.f;
    const float rBx = ok ? p.rB[r3 + c] : 0.f;
    const float rBy = ok ? p.rB[r3 + C + c] : 0.f;
    const float rBz = ok ? p.rB[r3 + 2 * C + c] : 0.f;
    nx[q] = ok ? p.nrm[r3 + c] : 0.f;
    ny[q] = ok ? p.nrm[r3 + C + c] : 0.f;
    nz[q] = ok ? p.nrm[r3 + 2 * C + c] : 0.f;
    meff[q] = ok ? p.mt[r2 + c] : 0.f;
    targ[q] = ok ? p.mt[r2 + C + c] : 0.f;
    hit[q] = ok ? p.hs[r2 + c] : 0.f;
    const float live = ok ? 1.0f - p.hs[r2 + C + c] : 0.f;
    vBx[q] = live * (pv[0] + (pv[4] * rBz - pv[5] * rBy));
    vBy[q] = live * (pv[1] + (pv[5] * rBx - pv[3] * rBz));
    vBz[q] = live * (pv[2] + (pv[3] * rBy - pv[4] * rBx));
    if (pair) wmax = fmaxf(wmax, hit[q] * live * pv[6]);
    if (WARM) {
      tangent_basis(nx[q], ny[q], nz[q], ux[q], uy[q], uz[q], tx[q], ty[q], tz[q]);
      an[q] = ok ? lin[r3 + c] : 0.f;
      au[q] = ok ? lin[r3 + C + c] : 0.f;
      av[q] = ok ? lin[r3 + 2 * C + c] : 0.f;
    }
  }

  for (int s = 0; s < p.S; ++s) {
#pragma unroll
    for (int q = 0; q < SPL; ++q) {
      const int c = lane + GS * q;
      const float vrx = (v0 + (w1 * rAz[q] - w2 * rAy[q])) - vBx[q];
      const float vry = (v1 + (w2 * rAx[q] - w0 * rAz[q])) - vBy[q];
      const float vrz = (v2 + (w0 * rAy[q] - w1 * rAx[q])) - vBz[q];
      const float vn = (vrx * nx[q] + vry * ny[q]) + vrz * nz[q];
      float ix, iy, iz;
      if (WARM) {
        const float dlam = -(vn - targ[q]) * meff[q];
        const float lam_new = fmaxf(an[q] + dlam, 0.0f) * hit[q];
        const float lam_n = lam_new - an[q];
        const float vtu = (vrx * ux[q] + vry * uy[q]) + vrz * uz[q];
        const float vtv = (vrx * tx[q] + vry * ty[q]) + vrz * tz[q];
        float lu = (au[q] - vtu * meff[q]) * hit[q];
        float lv = (av[q] - vtv * meff[q]) * hit[q];
        const float tl = sqrtf(lu * lu + lv * lv);
        const float cone = p.mu * lam_new;
        const float scl = tl > cone ? cone / fmaxf(tl, 1e-12f) : 1.0f;
        lu = lu * scl;
        lv = lv * scl;
        const float imp_u = lu - au[q], imp_v = lv - av[q];
        an[q] = lam_new;
        au[q] = lu;
        av[q] = lv;
        ix = hit[q] * ((lam_n * nx[q] + imp_u * ux[q]) + imp_v * tx[q]);
        iy = hit[q] * ((lam_n * ny[q] + imp_u * uy[q]) + imp_v * ty[q]);
        iz = hit[q] * ((lam_n * nz[q] + imp_u * uz[q]) + imp_v * tz[q]);
      } else {
        const float vtx = vrx - vn * nx[q];
        const float vty = vry - vn * ny[q];
        const float vtz = vrz - vn * nz[q];
        const float vt_len = sqrtf((vtx * vtx + vty * vty) + vtz * vtz);
        const float inv_vt = 1.0f / fmaxf(vt_len, 1e-9f);
        const float lam_n = fmaxf(-(vn - targ[q]) * meff[q], 0.0f);
        const float lam_t = fminf(vt_len * meff[q], p.mu * lam_n);
        ix = hit[q] * (lam_n * nx[q] - lam_t * vtx * inv_vt);
        iy = hit[q] * (lam_n * ny[q] - lam_t * vty * inv_vt);
        iz = hit[q] * (lam_n * nz[q] - lam_t * vtz * inv_vt);
      }
      if (c < C) {
        st[0 * CS + c] = ix;
        st[1 * CS + c] = iy;
        st[2 * CS + c] = iz;
        st[3 * CS + c] = rAy[q] * iz - rAz[q] * iy;
        st[4 * CS + c] = rAz[q] * ix - rAx[q] * iz;
        st[5 * CS + c] = rAx[q] * iy - rAy[q] * ix;
      }
    }
    __syncwarp();
    float sum = 0.0f;
    if (lane < 6)
      for (int c = 0; c < C; ++c) sum = sum + st[lane * CS + c];
    __syncwarp();  // the next substep overwrites the staged values
    const float sx = gshfl(sum, 0), sy = gshfl(sum, 1), sz = gshfl(sum, 2);
    const float tqx = gshfl(sum, 3), tqy = gshfl(sum, 4), tqz = gshfl(sum, 5);
    const float dwx = s_s * ((II[0] * tqx + II[1] * tqy) + II[2] * tqz);
    const float dwy = s_s * ((II[3] * tqx + II[4] * tqy) + II[5] * tqz);
    const float dwz = s_s * ((II[6] * tqx + II[7] * tqy) + II[8] * tqz);
    v0 = v0 + m_s * sx; v1 = v1 + m_s * sy; v2 = v2 + m_s * sz;
    w0 = w0 + dwx; w1 = w1 + dwy; w2 = w2 + dwz;
  }

#pragma unroll
  for (int off = GS / 2; off > 0; off >>= 1)
    wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, off, GS));
  if (!store) return;
  if (lane < 8) {
    const float o[8] = {v0, v1, v2, w0, w1, w2, fmaxf(wake_own, wmax), 0.0f};
    float val = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) val = lane == r ? o[r] : val;
    vout[(size_t)row * 8 + lane] = val;
  }
  if (WARM) {
#pragma unroll
    for (int q = 0; q < SPL; ++q) {
      const int c = lane + GS * q;
      if (c < C) {
        lout[r3 + c] = an[q];
        lout[r3 + C + c] = au[q];
        lout[r3 + 2 * C + c] = av[q];
      }
    }
  }
}

template <int SPL, bool WARM>
__global__ void __launch_bounds__(THREADS) solver_kernel(Params p) {
  __shared__ float stage[ROWS][6 * (SPL * GS + 1)];
  const int lane = threadIdx.x % GS, grp = threadIdx.x / GS;
  const int C = p.K * p.M + p.G;
  cg::grid_group grid = cg::this_grid();
  for (int it = 0; it < p.outer; ++it) {
    const float* vin = it == 0 ? p.vw0 : p.vw_buf + (size_t)((it - 1) & 1) * p.Np * 8;
    float* vout = p.vw_buf + (size_t)(it & 1) * p.Np * 8;
    const float* lin = nullptr;
    float* lout = nullptr;
    if (WARM) {
      lin = it == 0 ? p.lam0 : p.lam_buf + (size_t)((it - 1) & 1) * p.Np * 3 * C;
      lout = p.lam_buf + (size_t)(it & 1) * p.Np * 3 * C;
    }
    // Rows walk in steps of whole warps (two groups), so a warp's shuffles
    // stay converged; a group past the last row repeats it and stores nothing.
    const int per_warp = 32 / GS;
    const int wbase = (blockIdx.x * THREADS + threadIdx.x) / 32 * per_warp;
    const int wstep = gridDim.x * THREADS / 32 * per_warp;
    for (int base = wbase; base < p.Np; base += wstep) {
      const int row = base + grp % per_warp;
      solve_row<SPL, WARM>(p, min(row, p.Np - 1), row < p.Np, lane, stage[grp], vin, vout,
                           lin, lout);
    }
    if (it + 1 < p.outer) grid.sync();
  }
}

// The general variant, the last resort for any K and C: it runs only where
// the shared variant below does not fit a row in a block's shared memory
// (C > 2,311 at K = 32). The same groups of 16 lanes a row, each
// lane walking slots c = lane, lane + 16, ... of the row and re-reading its
// tables and its partner's state from device memory on every substep (the
// same values, so the same bits), the accumulated totals and the six
// staged components of each slot in the group's slice of a device scratch
// (9C floats), summed in slot order from 0 by six lanes as above.
template <bool WARM>
__device__ void solve_row_general(const Params& p, int row, bool store, int lane, float* st,
                                  float* acc, const float* vin, float* vout, const float* lin,
                                  float* lout) {
  const int C = p.K * p.M + p.G, KM = p.K * p.M;
  const size_t r3 = (size_t)row * 3 * C, r2 = (size_t)row * 2 * C;
  const float* own = vin + (size_t)row * 8;
  float v0 = own[0], v1 = own[1], v2 = own[2];
  float w0 = own[3], w1 = own[4], w2 = own[5];
  const float wake_own = own[6];
  const float m_s = p.scale[(size_t)row * 2 + 0], s_s = p.scale[(size_t)row * 2 + 1];
  float II[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) II[q] = p.iAI[(size_t)row * 9 + q];
  // Slot c's partner state: pair k = c % K's, zero for ground slots.
  auto partner = [&](int c, float (&pv)[7]) {
    const bool pair = c < KM;
    const float* q = pair ? vin + (size_t)p.pb[(size_t)row * p.K + c % p.K] * 8 : nullptr;
#pragma unroll
    for (int r = 0; r < 7; ++r) pv[r] = pair ? q[r] : 0.0f;
  };
  float wmax = 0.0f;
  for (int c = lane; c < C; c += GS) {
    if (c < KM) {
      float pv[7];
      partner(c, pv);
      const float live = 1.0f - p.hs[r2 + C + c];
      wmax = fmaxf(wmax, p.hs[r2 + c] * live * pv[6]);
    }
    if (WARM) {
      acc[c] = lin[r3 + c];
      acc[C + c] = lin[r3 + C + c];
      acc[2 * C + c] = lin[r3 + 2 * C + c];
    }
  }

  for (int s = 0; s < p.S; ++s) {
    for (int c = lane; c < C; c += GS) {
      float pv[7];
      partner(c, pv);
      const float rAx = p.rA[r3 + c], rAy = p.rA[r3 + C + c], rAz = p.rA[r3 + 2 * C + c];
      const float rBx = p.rB[r3 + c], rBy = p.rB[r3 + C + c], rBz = p.rB[r3 + 2 * C + c];
      const float nx = p.nrm[r3 + c], ny = p.nrm[r3 + C + c], nz = p.nrm[r3 + 2 * C + c];
      const float meff = p.mt[r2 + c], targ = p.mt[r2 + C + c], hit = p.hs[r2 + c];
      const float live = 1.0f - p.hs[r2 + C + c];
      const float vBx = live * (pv[0] + (pv[4] * rBz - pv[5] * rBy));
      const float vBy = live * (pv[1] + (pv[5] * rBx - pv[3] * rBz));
      const float vBz = live * (pv[2] + (pv[3] * rBy - pv[4] * rBx));
      const float vrx = (v0 + (w1 * rAz - w2 * rAy)) - vBx;
      const float vry = (v1 + (w2 * rAx - w0 * rAz)) - vBy;
      const float vrz = (v2 + (w0 * rAy - w1 * rAx)) - vBz;
      const float vn = (vrx * nx + vry * ny) + vrz * nz;
      float ix, iy, iz;
      if (WARM) {
        float ux, uy, uz, tx, ty, tz;
        tangent_basis(nx, ny, nz, ux, uy, uz, tx, ty, tz);
        const float an = acc[c], au = acc[C + c], av = acc[2 * C + c];
        const float dlam = -(vn - targ) * meff;
        const float lam_new = fmaxf(an + dlam, 0.0f) * hit;
        const float lam_n = lam_new - an;
        const float vtu = (vrx * ux + vry * uy) + vrz * uz;
        const float vtv = (vrx * tx + vry * ty) + vrz * tz;
        float lu = (au - vtu * meff) * hit;
        float lv = (av - vtv * meff) * hit;
        const float tl = sqrtf(lu * lu + lv * lv);
        const float cone = p.mu * lam_new;
        const float scl = tl > cone ? cone / fmaxf(tl, 1e-12f) : 1.0f;
        lu = lu * scl;
        lv = lv * scl;
        const float imp_u = lu - au, imp_v = lv - av;
        acc[c] = lam_new;
        acc[C + c] = lu;
        acc[2 * C + c] = lv;
        ix = hit * ((lam_n * nx + imp_u * ux) + imp_v * tx);
        iy = hit * ((lam_n * ny + imp_u * uy) + imp_v * ty);
        iz = hit * ((lam_n * nz + imp_u * uz) + imp_v * tz);
      } else {
        const float vtx = vrx - vn * nx;
        const float vty = vry - vn * ny;
        const float vtz = vrz - vn * nz;
        const float vt_len = sqrtf((vtx * vtx + vty * vty) + vtz * vtz);
        const float inv_vt = 1.0f / fmaxf(vt_len, 1e-9f);
        const float lam_n = fmaxf(-(vn - targ) * meff, 0.0f);
        const float lam_t = fminf(vt_len * meff, p.mu * lam_n);
        ix = hit * (lam_n * nx - lam_t * vtx * inv_vt);
        iy = hit * (lam_n * ny - lam_t * vty * inv_vt);
        iz = hit * (lam_n * nz - lam_t * vtz * inv_vt);
      }
      st[0 * C + c] = ix;
      st[1 * C + c] = iy;
      st[2 * C + c] = iz;
      st[3 * C + c] = rAy * iz - rAz * iy;
      st[4 * C + c] = rAz * ix - rAx * iz;
      st[5 * C + c] = rAx * iy - rAy * ix;
    }
    __syncwarp();
    float sum = 0.0f;
    if (lane < 6)
      for (int c = 0; c < C; ++c) sum = sum + st[lane * C + c];
    __syncwarp();  // the next substep overwrites the staged values
    const float sx = gshfl(sum, 0), sy = gshfl(sum, 1), sz = gshfl(sum, 2);
    const float tqx = gshfl(sum, 3), tqy = gshfl(sum, 4), tqz = gshfl(sum, 5);
    const float dwx = s_s * ((II[0] * tqx + II[1] * tqy) + II[2] * tqz);
    const float dwy = s_s * ((II[3] * tqx + II[4] * tqy) + II[5] * tqz);
    const float dwz = s_s * ((II[6] * tqx + II[7] * tqy) + II[8] * tqz);
    v0 = v0 + m_s * sx; v1 = v1 + m_s * sy; v2 = v2 + m_s * sz;
    w0 = w0 + dwx; w1 = w1 + dwy; w2 = w2 + dwz;
  }

#pragma unroll
  for (int off = GS / 2; off > 0; off >>= 1)
    wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, off, GS));
  if (!store) return;
  if (lane < 8) {
    const float o[8] = {v0, v1, v2, w0, w1, w2, fmaxf(wake_own, wmax), 0.0f};
    float val = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) val = lane == r ? o[r] : val;
    vout[(size_t)row * 8 + lane] = val;
  }
  if (WARM)
    for (int c = lane; c < C; c += GS) {
      lout[r3 + c] = acc[c];
      lout[r3 + C + c] = acc[C + c];
      lout[r3 + 2 * C + c] = acc[2 * C + c];
    }
}

template <bool WARM>
__global__ void __launch_bounds__(THREADS) solver_general_kernel(Params p, float* scratch) {
  const int lane = threadIdx.x % GS, grp = threadIdx.x / GS;
  const int C = p.K * p.M + p.G;
  float* st = scratch + ((size_t)blockIdx.x * ROWS + grp) * 9 * C;   // 6C staged, 3C totals
  cg::grid_group grid = cg::this_grid();
  for (int it = 0; it < p.outer; ++it) {
    const float* vin = it == 0 ? p.vw0 : p.vw_buf + (size_t)((it - 1) & 1) * p.Np * 8;
    float* vout = p.vw_buf + (size_t)(it & 1) * p.Np * 8;
    const float* lin = nullptr;
    float* lout = nullptr;
    if (WARM) {
      lin = it == 0 ? p.lam0 : p.lam_buf + (size_t)((it - 1) & 1) * p.Np * 3 * C;
      lout = p.lam_buf + (size_t)(it & 1) * p.Np * 3 * C;
    }
    const int per_warp = 32 / GS;
    const int wbase = (blockIdx.x * THREADS + threadIdx.x) / 32 * per_warp;
    const int wstep = gridDim.x * THREADS / 32 * per_warp;
    for (int base = wbase; base < p.Np; base += wstep) {
      const int row = base + grp % per_warp;
      solve_row_general<WARM>(p, min(row, p.Np - 1), row < p.Np, lane, st, st + 6 * C, vin,
                              vout, lin, lout);
    }
    if (it + 1 < p.outer) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// The shared variant, for any K and C whose row fits a block's opt-in shared
// memory (the register kernel above takes K <= 16 and C <= 128). A warp a
// row, slot c on lane c % 32. Per warp, in shared memory (floats; every
// region a multiple of 4, so the 16-byte copies stay aligned):
//   the row's B8 tables rA, rB, n (3C each), mt, hs (2C each), each the
//   16-byte aligned cover of its row, copied by 16-byte loads; scale and
//   I_A^-1 (11, in 12);
//   vB (3C): each slot's partner velocity at the contact, once an iteration;
//   the K partner states (7 floats each: an odd stride, so the slots of a
//   warp read them from distinct banks), gathered once an iteration by lanes
//   0..K-1 (in passes where K > 32), and the K partner indices;
//   the six staged impulse and torque components (6 x CS4 floats, CS4 a
//   multiple of 4 with CS4 / 4 odd: the six summing lanes read their rows
//   16 bytes at a time from six disjoint groups of four banks);
//   in warm mode the totals [lam_n | lam_u | lam_v] (3C).
// Where the cooperative grid holds every row, each warp keeps one row over
// the iterations: its tables load once a solve and its warm totals stay in
// shared memory (written out after the last iteration); past that the warps
// walk the rows and restage each row once an iteration. The iterations meet
// at a grid-wide barrier, reading one state buffer and writing the other,
// as in the kernel above.
// What bounds it: a substep's slot sums stay serial from slot 0 on six lanes
// (the plain version's order): C dependent shared loads and adds a substep,
// this design's floor at small Np. The slot work itself is 13 shared loads
// and ~95 flops a slot a substep on 32 lanes.
// ---------------------------------------------------------------------------

constexpr int SH_WARPS = 4;   // rows of a CTA at most

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }
// Floats of the 16-byte aligned cover of n floats starting anywhere.
__host__ __device__ inline int cover(int n) { return (n + 3 + 3) / 4 * 4; }

// The staged components' stride: C rounded up to 4, an odd number of quads.
__host__ __device__ inline int stage_stride(int C) { return (((C + 3) / 4) | 1) * 4; }

// Floats of one row's shared state (solver_cuda.shared_bytes mirrors it).
__host__ __device__ inline long long shared_row_floats(int K, int C, bool warm) {
  return 3LL * cover(3 * C) + 2LL * cover(2 * C) + 12 + round4(3 * C) + round4(7 * K) +
         round4(K) + 6LL * stage_stride(C) + (warm ? cover(3 * C) : 0);
}

// The 16-byte aligned cover of the n floats at src, to be copied to dst
// (16-byte aligned): its 16-byte blocks, and src's offset in dst.
struct Cover {
  const float4* s;
  float4* d;
  int n4, off;
};

__device__ inline Cover cover_of(float* dst, const float* src, int n) {
  const int off = (int)(((size_t)src & 15) >> 2);
  return {reinterpret_cast<const float4*>(src - off), reinterpret_cast<float4*>(dst),
          (off + n + 3) >> 2, off};
}

// Copies up to six covers together, 16 bytes a lane: every load of a round
// is issued before its stores, so the row costs a few memory latencies and
// not one a table and a round.
template <int NC>
__device__ inline void stage_covers(const Cover (&cv)[NC], int lane) {
  int n4 = 0;
#pragma unroll
  for (int t = 0; t < NC; ++t) n4 = max(n4, cv[t].n4);
#pragma unroll 2
  for (int v = lane; v < n4; v += 32) {
    float4 x[NC];
#pragma unroll
    for (int t = 0; t < NC; ++t)
      if (v < cv[t].n4) x[t] = cv[t].s[v];
#pragma unroll
    for (int t = 0; t < NC; ++t)
      if (v < cv[t].n4) cv[t].d[v] = x[t];
  }
}

__device__ inline float wshfl(float v, int src) { return __shfl_sync(0xffffffffu, v, src); }

template <bool WARM>
__global__ void __launch_bounds__(32 * SH_WARPS) solver_shared_kernel(Params p) {
  extern __shared__ float4 sh4[];
  const int C = p.K * p.M + p.G, KM = p.K * p.M;
  const int CS = stage_stride(C);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  float* base = reinterpret_cast<float*>(sh4) + (size_t)warp * shared_row_floats(p.K, C, WARM);
  float* sA = base;
  float* sB = sA + cover(3 * C);
  float* sN = sB + cover(3 * C);
  float* sMT = sN + cover(3 * C);
  float* sHS = sMT + cover(2 * C);
  float* misc = sHS + cover(2 * C);   // scale (2) and I_A^-1 (9)
  float* vb = misc + 12;
  float* ps = vb + round4(3 * C);
  int* spb = reinterpret_cast<int*>(ps + round4(7 * p.K));   // partner indices
  float* st = ps + round4(7 * p.K) + round4(p.K);
  float* acb = st + 6 * CS;          // warm totals
  const int stride = gridDim.x * W;
  const bool fixed = stride >= p.Np;   // a row a warp over every iteration
  const float *tA = sA, *tB = sB, *tN = sN, *tMT = sMT, *tHS = sHS;
  float* ac = acb;
  cg::grid_group grid = cg::this_grid();
  for (int it = 0; it < p.outer; ++it) {
    const float* vin = it == 0 ? p.vw0 : p.vw_buf + (size_t)((it - 1) & 1) * p.Np * 8;
    float* vout = p.vw_buf + (size_t)(it & 1) * p.Np * 8;
    const float* lin = nullptr;
    float* lout = nullptr;
    if (WARM) {
      lin = it == 0 ? p.lam0 : p.lam_buf + (size_t)((it - 1) & 1) * p.Np * 3 * C;
      lout = p.lam_buf + (size_t)(it & 1) * p.Np * 3 * C;
    }
    for (int row = blockIdx.x * W + warp; row < p.Np; row += stride) {
      const size_t r3 = (size_t)row * 3 * C, r2 = (size_t)row * 2 * C;
      if (!fixed || it == 0) {
        const Cover cv[6] = {cover_of(sA, p.rA + r3, 3 * C), cover_of(sB, p.rB + r3, 3 * C),
                             cover_of(sN, p.nrm + r3, 3 * C), cover_of(sMT, p.mt + r2, 2 * C),
                             cover_of(sHS, p.hs + r2, 2 * C),
                             WARM ? cover_of(acb, lin + r3, 3 * C) : Cover{nullptr, nullptr, 0, 0}};
        stage_covers(cv, lane);
        tA = sA + cv[0].off;
        tB = sB + cv[1].off;
        tN = sN + cv[2].off;
        tMT = sMT + cv[3].off;
        tHS = sHS + cv[4].off;
        if (WARM) ac = acb + cv[5].off;
        if (lane < 2) misc[lane] = p.scale[(size_t)row * 2 + lane];
        else if (lane < 11) misc[lane] = p.iAI[(size_t)row * 9 + lane - 2];
        for (int k = lane; k < p.K; k += 32) spb[k] = p.pb[(size_t)row * p.K + k];
        __syncwarp();
      }
      // The row's own state and the K partner states of the previous
      // iteration, loaded together.
      const float* own = vin + (size_t)row * 8;
      float v0 = own[0], v1 = own[1], v2 = own[2];
      float w0 = own[3], w1 = own[4], w2 = own[5];
      const float wake_own = own[6];
      for (int k = lane; k < p.K; k += 32) {
        const float* q = vin + (size_t)spb[k] * 8;
#pragma unroll
        for (int r = 0; r < 7; ++r) ps[k * 7 + r] = q[r];
      }
      __syncwarp();
      const float m_s = misc[0], s_s = misc[1];
      float II[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) II[q] = misc[2 + q];
      // Each slot's partner velocity at the contact, and the wake max.
      float wmax = 0.0f;
#pragma unroll 4
      for (int c = lane; c < C; c += 32) {
        const bool pair = c < KM;
        const int k = pair ? c % p.K : 0;
        float pv[7];
#pragma unroll
        for (int r = 0; r < 7; ++r) pv[r] = pair ? ps[k * 7 + r] : 0.0f;
        const float rBx = tB[c], rBy = tB[C + c], rBz = tB[2 * C + c];
        const float live = 1.0f - tHS[C + c];
        vb[c] = live * (pv[0] + (pv[4] * rBz - pv[5] * rBy));
        vb[C + c] = live * (pv[1] + (pv[5] * rBx - pv[3] * rBz));
        vb[2 * C + c] = live * (pv[2] + (pv[3] * rBy - pv[4] * rBx));
        if (pair) wmax = fmaxf(wmax, tHS[c] * live * pv[6]);
      }

      for (int s = 0; s < p.S; ++s) {
#pragma unroll 4
        for (int c = lane; c < C; c += 32) {
          const float rAx = tA[c], rAy = tA[C + c], rAz = tA[2 * C + c];
          const float nx = tN[c], ny = tN[C + c], nz = tN[2 * C + c];
          const float meff = tMT[c], targ = tMT[C + c], hit = tHS[c];
          const float vrx = (v0 + (w1 * rAz - w2 * rAy)) - vb[c];
          const float vry = (v1 + (w2 * rAx - w0 * rAz)) - vb[C + c];
          const float vrz = (v2 + (w0 * rAy - w1 * rAx)) - vb[2 * C + c];
          const float vn = (vrx * nx + vry * ny) + vrz * nz;
          float ix, iy, iz;
          if (WARM) {
            float ux, uy, uz, tx, ty, tz;
            tangent_basis(nx, ny, nz, ux, uy, uz, tx, ty, tz);
            const float an = ac[c], au = ac[C + c], av = ac[2 * C + c];
            const float dlam = -(vn - targ) * meff;
            const float lam_new = fmaxf(an + dlam, 0.0f) * hit;
            const float lam_n = lam_new - an;
            const float vtu = (vrx * ux + vry * uy) + vrz * uz;
            const float vtv = (vrx * tx + vry * ty) + vrz * tz;
            float lu = (au - vtu * meff) * hit;
            float lv = (av - vtv * meff) * hit;
            const float tl = sqrtf(lu * lu + lv * lv);
            const float cone = p.mu * lam_new;
            const float scl = tl > cone ? cone / fmaxf(tl, 1e-12f) : 1.0f;
            lu = lu * scl;
            lv = lv * scl;
            const float imp_u = lu - au, imp_v = lv - av;
            ac[c] = lam_new;
            ac[C + c] = lu;
            ac[2 * C + c] = lv;
            ix = hit * ((lam_n * nx + imp_u * ux) + imp_v * tx);
            iy = hit * ((lam_n * ny + imp_u * uy) + imp_v * ty);
            iz = hit * ((lam_n * nz + imp_u * uz) + imp_v * tz);
          } else {
            const float vtx = vrx - vn * nx;
            const float vty = vry - vn * ny;
            const float vtz = vrz - vn * nz;
            const float vt_len = sqrtf((vtx * vtx + vty * vty) + vtz * vtz);
            const float inv_vt = 1.0f / fmaxf(vt_len, 1e-9f);
            const float lam_n = fmaxf(-(vn - targ) * meff, 0.0f);
            const float lam_t = fminf(vt_len * meff, p.mu * lam_n);
            ix = hit * (lam_n * nx - lam_t * vtx * inv_vt);
            iy = hit * (lam_n * ny - lam_t * vty * inv_vt);
            iz = hit * (lam_n * nz - lam_t * vtz * inv_vt);
          }
          st[0 * CS + c] = ix;
          st[1 * CS + c] = iy;
          st[2 * CS + c] = iz;
          st[3 * CS + c] = rAy * iz - rAz * iy;
          st[4 * CS + c] = rAz * ix - rAx * iz;
          st[5 * CS + c] = rAx * iy - rAy * ix;
        }
        __syncwarp();
        // The slot sums in slot order from 0, 16 bytes a load.
        float sum = 0.0f;
        if (lane < 6) {
          const float* sl = st + lane * CS;
          const float4* s4 = reinterpret_cast<const float4*>(sl);
          const int n4 = C >> 2;
          int t = 0;
          for (; t + 4 <= n4; t += 4) {
            const float4 a = s4[t], b = s4[t + 1], c = s4[t + 2], d = s4[t + 3];
            sum = sum + a.x; sum = sum + a.y; sum = sum + a.z; sum = sum + a.w;
            sum = sum + b.x; sum = sum + b.y; sum = sum + b.z; sum = sum + b.w;
            sum = sum + c.x; sum = sum + c.y; sum = sum + c.z; sum = sum + c.w;
            sum = sum + d.x; sum = sum + d.y; sum = sum + d.z; sum = sum + d.w;
          }
          for (; t < n4; ++t) {
            const float4 a = s4[t];
            sum = sum + a.x; sum = sum + a.y; sum = sum + a.z; sum = sum + a.w;
          }
          for (int c = 4 * n4; c < C; ++c) sum = sum + sl[c];
        }
        __syncwarp();  // the next substep overwrites the staged values
        const float sx = wshfl(sum, 0), sy = wshfl(sum, 1), sz = wshfl(sum, 2);
        const float tqx = wshfl(sum, 3), tqy = wshfl(sum, 4), tqz = wshfl(sum, 5);
        const float dwx = s_s * ((II[0] * tqx + II[1] * tqy) + II[2] * tqz);
        const float dwy = s_s * ((II[3] * tqx + II[4] * tqy) + II[5] * tqz);
        const float dwz = s_s * ((II[6] * tqx + II[7] * tqy) + II[8] * tqz);
        v0 = v0 + m_s * sx; v1 = v1 + m_s * sy; v2 = v2 + m_s * sz;
        w0 = w0 + dwx; w1 = w1 + dwy; w2 = w2 + dwz;
      }

#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
      if (lane < 8) {
        const float o[8] = {v0, v1, v2, w0, w1, w2, fmaxf(wake_own, wmax), 0.0f};
        float val = 0.0f;
#pragma unroll
        for (int r = 0; r < 8; ++r) val = lane == r ? o[r] : val;
        vout[(size_t)row * 8 + lane] = val;
      }
      if (WARM && (!fixed || it + 1 == p.outer))
        for (int c = lane; c < C; c += 32) {
          lout[r3 + c] = ac[c];
          lout[r3 + C + c] = ac[C + c];
          lout[r3 + 2 * C + c] = ac[2 * C + c];
        }
      __syncwarp();  // the next row overwrites this one's shared state
    }
    if (it + 1 < p.outer) grid.sync();
  }
}

// Rows of a CTA of the shared variant: up to SH_WARPS, as many as fit.
inline int shared_warps(long long row_bytes) {
  const long long w = 232448 / row_bytes;
  return (int)(w < SH_WARPS ? w : SH_WARPS);
}

template <bool WARM>
int launch_shared(const Params& p, cudaStream_t stream) {
  const int C = p.K * p.M + p.G;
  const long long rb = 4 * shared_row_floats(p.K, C, WARM);
  const int W = shared_warps(rb);
  if (W < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(W * rb);
  static size_t set_smem = 0;
  static int per_sm = -1, sms = 0;
  static size_t occ_smem = 0;
  static int occ_w = 0;
  if (smem > set_smem) {
    const cudaError_t e = cudaFuncSetAttribute(solver_shared_kernel<WARM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    set_smem = smem;
  }
  if (per_sm < 0 || occ_smem != smem || occ_w != W) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solver_shared_kernel<WARM>, 32 * W,
                                                  smem);
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    occ_smem = smem;
    occ_w = W;
  }
  int blocks = (p.Np + W - 1) / W;
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  Params q = p;
  void* args[] = {&q};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)solver_shared_kernel<WARM>,
                                                    dim3(blocks), dim3(32 * W), args, smem,
                                                    stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool WARM>
int launch_general(Params p, float* scratch, int max_blocks, cudaStream_t stream) {
  static int per_sm = -1;
  static int sms = 0;
  if (per_sm < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solver_general_kernel<WARM>, THREADS,
                                                  0);
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  int blocks = (p.Np + ROWS - 1) / ROWS;
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  if (blocks > max_blocks) blocks = max_blocks;
  void* args[] = {&p, &scratch};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)solver_general_kernel<WARM>,
                                                    dim3(blocks), dim3(THREADS), args, 0, stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int SPL, bool WARM>
int launch(Params p, cudaStream_t stream) {
  static int per_sm = -1;
  static int sms = 0;
  if (per_sm < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solver_kernel<SPL, WARM>, THREADS, 0);
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int want = (p.Np + ROWS - 1) / ROWS;
  const int blocks = want < per_sm * sms ? want : per_sm * sms;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)solver_kernel<SPL, WARM>,
                                                    dim3(blocks), dim3(THREADS), args, 0, stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool WARM>
int dispatch(const Params& p, cudaStream_t stream) {
  const int spl = (p.K * p.M + p.G + GS - 1) / GS;
  switch (spl) {
    case 1: return launch<1, WARM>(p, stream);
    case 2: return launch<2, WARM>(p, stream);
    case 3: return launch<3, WARM>(p, stream);
    case 4: return launch<4, WARM>(p, stream);
    case 5: case 6: case 7: case 8: return launch<8, WARM>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// `outer` iterations of S substeps from state vw0 (and totals lam0 in warm
// mode); iteration i writes vw_buf[i % 2] (and lam_buf[i % 2]). With a null
// scratch, C = K·M + G must be at most 8·16 = 128 and K at most 16 (the
// register variant); with one, the general variant (the last resort past
// the shared variant's room) runs on at most `max_blocks` CTAs, the
// scratch holding max_blocks · 8 · 9C floats.
extern "C" int surtr_solver_solve(const float* vw0, const int* pb, const float* rA,
                                  const float* rB, const float* nrm, const float* mt,
                                  const float* hs, const float* scale, const float* iAI,
                                  const float* lam0, float* vw_buf, float* lam_buf, int Np, int K,
                                  int M, int G, int S, int outer, float mu, float* scratch,
                                  int max_blocks, void* stream) {
  if (Np <= 0 || outer <= 0) return 0;
  if (K < 0 || (lam0 == nullptr) != (lam_buf == nullptr)) return (int)cudaErrorInvalidValue;
  const Params p{vw0, pb, rA, rB, nrm, mt, hs, scale, iAI, lam0, vw_buf, lam_buf,
                 Np, K, M, G, S, outer, mu};
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch != nullptr) {
    if (max_blocks < 1) return (int)cudaErrorInvalidValue;
    return lam0 ? launch_general<true>(p, scratch, max_blocks, st)
                : launch_general<false>(p, scratch, max_blocks, st);
  }
  if (K < 1 || K > GS) return (int)cudaErrorInvalidValue;
  return lam0 ? dispatch<true>(p, st) : dispatch<false>(p, st);
}

// Bytes of one row's shared state in the shared variant (a CTA holds up to
// 4 rows); the variant takes every (K, C) whose row fits 232,448 B.
extern "C" long long surtr_solver_shared_bytes(int K, int C, int warm) {
  return 4 * shared_row_floats(K, C, warm != 0);
}

// The shared variant: the same arguments and outputs as surtr_solver_solve,
// any K >= 1 and C whose row fits a block's shared memory.
extern "C" int surtr_solver_solve_shared(const float* vw0, const int* pb, const float* rA,
                                         const float* rB, const float* nrm, const float* mt,
                                         const float* hs, const float* scale, const float* iAI,
                                         const float* lam0, float* vw_buf, float* lam_buf, int Np,
                                         int K, int M, int G, int S, int outer, float mu,
                                         void* stream) {
  if (Np <= 0 || outer <= 0) return 0;
  if (K < 1 || (lam0 == nullptr) != (lam_buf == nullptr)) return (int)cudaErrorInvalidValue;
  const Params p{vw0, pb, rA, rB, nrm, mt, hs, scale, iAI, lam0, vw_buf, lam_buf,
                 Np, K, M, G, S, outer, mu};
  cudaStream_t st = (cudaStream_t)stream;
  return lam0 ? launch_shared<true>(p, st) : launch_shared<false>(p, st);
}
