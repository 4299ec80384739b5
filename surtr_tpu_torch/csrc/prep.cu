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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PS = 21;  // shared stride of a partner's 20 fields

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

// GLOBAL (the general variant, for rows past the shared memory a block may
// take): one row a block, block b of a launch staging row rbase + b in its
// slice of a device scratch instead of shared memory; the same steps.
template <bool GLOBAL>
__global__ void __launch_bounds__(THREADS) prep_kernel(
    const float* __restrict__ raw, const int* __restrict__ pidx, const float* __restrict__ gpts,
    const float* __restrict__ gd, int gd_stride, const uint8_t* __restrict__ ghit,
    const float* __restrict__ x, const float* __restrict__ v0, const float* __restrict__ w0,
    const float* __restrict__ invm, const float* __restrict__ invI,
    const uint8_t* __restrict__ asleep, float* __restrict__ rA, float* __restrict__ rB,
    float* __restrict__ nrm, float* __restrict__ mt, float* __restrict__ hs,
    float* __restrict__ scale, float* __restrict__ iAI, float* __restrict__ vn0_out, int Np,
    int K, int M, int G, int RB, float slop, float bias_coef, float neg_rest,
    float bounce_thr, float* __restrict__ scratch, int rbase) {
  extern __shared__ float smem_rows[];
  const int C = K * M + G, KM = K * M, R = 5 + 6 * M;
  float* const sm = GLOBAL ? scratch + (size_t)blockIdx.x * row_floats(K, M, G) : smem_rows;
  const int row0 = (GLOBAL ? rbase : 0) + blockIdx.x * RB;
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

// Rows a block takes and the shared bytes they need: RB·C close to the
// block's 256 threads, within the 48 KB a launch may take without opting in;
// 0 rows if one row does not fit (the general variant takes those shapes).
int rows_per_block(int K, int M, int G, size_t* smem) {
  const int C = K * M + G;
  const size_t per_row = (size_t)row_floats(K, M, G) * sizeof(float);
  int rb = C > 0 ? THREADS / C : THREADS;
  if (rb < 1) rb = 1;
  while (rb > 0 && (size_t)rb * per_row > 48 * 1024) --rb;
  *smem = (size_t)rb * per_row;
  return rb;
}

}  // namespace

extern "C" long long surtr_prep_row_bytes(int K, int M, int G) {
  return (long long)row_floats(K, M, G) * sizeof(float);
}

// scratch: `chunk` rows of the general variant's staging (null for the
// shared variant); the general variant runs ceil(Np / chunk) launches.
// *launched counts the launches.
extern "C" int surtr_prep(const float* raw, const int* pidx, const float* gpts, const float* gd,
                          int gd_stride, const uint8_t* ghit, const float* x, const float* v0,
                          const float* w0, const float* invm, const float* invI,
                          const uint8_t* asleep, float* rA, float* rB, float* nrm, float* mt,
                          float* hs, float* scale, float* iAI, float* vn0, int Np, int K, int M,
                          int G, float slop, float bias_coef, float neg_rest, float bounce_thr,
                          float* scratch, int chunk, int* launched, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  *launched = 0;
  if (scratch != nullptr) {
    if (chunk < 1) return (int)cudaErrorInvalidValue;
    for (int r0 = 0; r0 < Np; r0 += chunk) {
      const int n = Np - r0 < chunk ? Np - r0 : chunk;
      prep_kernel<true><<<n, THREADS, 0, st>>>(
          raw, pidx, gpts, gd, gd_stride, ghit, x, v0, w0, invm, invI, asleep, rA, rB, nrm, mt,
          hs, scale, iAI, vn0, Np, K, M, G, 1, slop, bias_coef, neg_rest, bounce_thr, scratch,
          r0);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      ++*launched;
    }
    return 0;
  }
  size_t smem;
  const int rb = rows_per_block(K, M, G, &smem);
  if (rb <= 0) return (int)cudaErrorInvalidValue;
  if (Np > 0) {
    prep_kernel<false><<<(Np + rb - 1) / rb, THREADS, smem, st>>>(
        raw, pidx, gpts, gd, gd_stride, ghit, x, v0, w0, invm, invI, asleep, rA, rB, nrm, mt,
        hs, scale, iAI, vn0, Np, K, M, G, rb, slop, bias_coef, neg_rest, bounce_thr, nullptr, 0);
    *launched = 1;
  }
  return (int)cudaGetLastError();
}
