// Morton-window broadphase with the mutual mask (kernel B12).
//
// Replaces: surtr_tpu/physics/broadphase_pallas.py `_bp_kernel` (wrapper
// `broadphase_sorted_pallas`). Semantics of the plain version in
// surtr_tpu_torch/physics/broadphase_cuda.py `broadphase_sorted_reference`:
// pieces sorted by Morton code (glue: codes and a stable sort in PyTorch,
// as the JAX package keeps them in XLA) into a (Np, 11) table [center 3 |
// lo 3 | hi 3 | owner | valid]. Sorted lane r scans its 2W candidates in
// delta order [+1..+W, -1..-W]; a candidate r + d inside [0, Np) scores
// -d² (d² = ((dx·dx) + dy·dy) + dz·dz, own center minus the candidate's)
// when the AABBs overlap, both are valid and the owners differ, else -BIG.
// The lane keeps the K best (stable: ties, and filler at -BIG, go to the
// earliest delta). Slot k names the piece at rank clamp(r + d, 0, Np - 1)
// and is live when its score is real and the partner lane r + d selected
// its own -d slot (mutual).
//
// What bounds it on the card: operations, ~25 per candidate over
// Np · 2W candidates (10,000 × 64 at the 10k lattice, with the halo lanes
// below 1.5× that), microseconds at the FP32 rate; the table is 44 B a
// piece.
// Design: mutuality needs every lane's selection first, and blocks run in
// no order, so each CTA owns T = 128 lanes and also selects for the W lanes
// on either side (a halo, recomputed by the neighbour blocks too) from
// rows [t0 - 2W, t0 + T + 2W) staged in shared memory. The selections
// (K delta indices a lane) stay in shared memory; after one barrier each
// own lane checks its live slots against its partners' selections. One
// launch, no second pass over device memory. The K best are kept sorted by
// (score, delta index) in registers (K ≤ 16, unrolled constants only).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int T = 128;
constexpr int MAXK = 16;
constexpr int NF = 11;        // floats a row
constexpr float BIG = 3.4e38f;

__device__ inline int delta_of(int c, int W) { return c < W ? c + 1 : W - 1 - c; }

__global__ void __launch_bounds__(T)
bp_sorted_kernel(const float* __restrict__ pack, const int* __restrict__ order, int Np, int K,
                 int W, int* __restrict__ pidx, unsigned char* __restrict__ pok) {
  extern __shared__ float smem[];
  const int t0 = blockIdx.x * T;
  const int R = T + 4 * W;                 // staged rows: ranks [t0 - 2W, t0 + T + 2W)
  const int L = T + 2 * W;                 // selecting lanes: ranks [t0 - W, t0 + T + W)
  float* rows = smem;
  short* picks = reinterpret_cast<short*>(rows + R * NF);        // (L, K) delta indices
  unsigned char* real = reinterpret_cast<unsigned char*>(picks + L * K);  // (T, K)
  const int base = t0 - 2 * W;
  for (int i = threadIdx.x; i < R * NF; i += T) {
    const int g = base + i / NF;
    rows[i] = (g >= 0 && g < Np) ? pack[(size_t)g * NF + i % NF] : 0.0f;
  }
  __syncthreads();

  for (int l = threadIdx.x; l < L; l += T) {
    const int r = t0 - W + l;
    if (r < 0 || r >= Np) continue;
    const float* me = rows + (l + W) * NF;
    const bool mval = me[10] > 0.5f;
    float bs[MAXK];
    short bi[MAXK];
#pragma unroll
    for (int s = 0; s < MAXK; ++s) {
      bs[s] = -INFINITY;
      bi[s] = 0x7fff;
    }
    float kth = -INFINITY;
    for (int c = 0; c < 2 * W; ++c) {
      const int d = delta_of(c, W);
      const int rj = r + d;
      float score = -BIG;
      if (rj >= 0 && rj < Np) {
        const float* o = rows + (l + W + d) * NF;
        const bool ok = mval && o[10] > 0.5f && o[9] != me[9] && me[3] <= o[6] &&
                        o[3] <= me[6] && me[4] <= o[7] && o[4] <= me[7] && me[5] <= o[8] &&
                        o[5] <= me[8];
        if (ok) {
          const float dx = me[0] - o[0], dy = me[1] - o[1], dz = me[2] - o[2];
          float d2 = dx * dx;
          d2 = d2 + dy * dy;
          d2 = d2 + dz * dz;
          score = -d2;
        }
      }
      if (!(score > kth)) continue;        // a tie with the K-th keeps the earlier delta
      float sv = score;
      short si = (short)c;
#pragma unroll
      for (int s = 0; s < MAXK; ++s) {
        if (s < K && (sv > bs[s] || (sv == bs[s] && si < bi[s]))) {
          const float tv = bs[s];
          const short ti = bi[s];
          bs[s] = sv;
          bi[s] = si;
          sv = tv;
          si = ti;
        }
      }
#pragma unroll
      for (int s = 0; s < MAXK; ++s)
        if (s == K - 1) kth = bs[s];
    }
#pragma unroll
    for (int s = 0; s < MAXK; ++s) {
      if (s < K) {
        picks[l * K + s] = bi[s];
        if (l >= W && l < W + T) real[(l - W) * K + s] = bs[s] > -BIG / 2;
      }
    }
  }
  __syncthreads();

  const int r = t0 + threadIdx.x;
  if (r >= Np) return;
  const int l = threadIdx.x + W;
  const int o = order[r];
  for (int s = 0; s < K; ++s) {
    const int d = delta_of(picks[l * K + s], W);
    const int rj = min(max(r + d, 0), Np - 1);
    pidx[(size_t)o * K + s] = order[rj];
    bool live = real[threadIdx.x * K + s];
    if (live) {
      const short back = (short)(d > 0 ? W + d - 1 : -d - 1);
      const short* pj = picks + (l + d) * K;
      bool m = false;
      for (int kk = 0; kk < K; ++kk) m = m || pj[kk] == back;
      live = m;
    }
    pok[(size_t)o * K + s] = live;
  }
}

}  // namespace

extern "C" int surtr_broadphase_sorted(const float* pack, const int* order, int Np, int K, int W,
                                       int* pidx, unsigned char* pok, void* stream) {
  if (K < 1 || K > MAXK || K > 2 * W || W > 128) return (int)cudaErrorInvalidValue;
  const int R = T + 4 * W, L = T + 2 * W;
  const size_t smem = (size_t)R * NF * sizeof(float) + (size_t)L * K * sizeof(short) + T * K;
  if (Np > 0)
    bp_sorted_kernel<<<(Np + T - 1) / T, T, smem, (cudaStream_t)stream>>>(pack, order, Np, K, W,
                                                                         pidx, pok);
  return (int)cudaGetLastError();
}
