// Full-recall sweep-and-prune broadphase (kernel B6).
//
// Replaces: surtr_tpu/physics/broadphase_pallas.py `_bp_exact_kernel`
// (wrapper `broadphase_exact_pallas`). Semantics of the plain version in
// surtr_tpu_torch/physics/broadphase_cuda.py `broadphase_exact_reference`:
// for each valid piece i, the K smallest keys (q(d²) << id_bits) | j over
// every valid j of another owner (j != i) whose margin AABB overlaps i's,
// with d² = ((dx·dx) + dy·dy) + dz·dz of centers normalized to the valid
// extent (d = j's center minus i's) and q = (int)min(d²·qs, qmax); θᵢ is the
// K-th key, IMAX when fewer than K. Keys are unique (the id field), so the
// K smallest do not depend on the order candidates are met in.
//
// The glue (`exact_glue`, PyTorch on the device) sorts the pieces along the
// axis of largest valid extent into a (Np_pad, 16) table [normalized center
// 3 | lo 3 | hi 3 | owner | valid | id | pad 4], builds per-chunk AABB
// unions `cab` (NCH, 6) and each 128-piece block's contiguous range of
// 128-row chunks `rng` (NCH, 2) from monotone envelopes of the chunks'
// sweep-axis intervals: every chunk holding a piece that overlaps the block
// lies in the range. On the TPU the range came by scalar prefetch; here the
// block reads it itself.
//
// What bounds the function on the card: its bytes, 117 B a piece in and
// out (1.2 MB at the 10k lattice, a fraction of a microsecond); the keys
// themselves need work only for the overlapping pairs. The sweep does more:
// about 20 operations (6 compares, the flags, the d² and the key) per
// candidate test over the chunks its ranges select (chip_smoke.py prints
// both counts).
// Design: one CTA per 128-piece block of the sorted order, one thread per
// piece. The block reduces its valid lanes' AABB union and skips a chunk
// whose union misses it (a block-uniform test); it stages each accepted
// chunk (128 rows of 16 floats, 8 KB) in shared memory, which all threads
// then read as broadcasts. Each thread keeps its K best keys sorted in
// registers (K ≤ 16, indexed by unrolled constants only) and inserts only a
// key below its K-th. Blocks carry nothing between them. The results are
// written in original piece order: pidx = key & id_mask, pok = key != IMAX,
// key_ji = (key & ~id_mask) | i and θ.

#include <cuda_runtime.h>

namespace {

constexpr int CH = 128;       // pieces per block and rows per chunk
constexpr int MAXK = 16;
constexpr int IMAX = 0x7FFFFFFF;
constexpr float BIG = 3.4e38f;

__device__ inline float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(CH)
bp_exact_kernel(const float* __restrict__ pack, const float* __restrict__ cab,
                const int* __restrict__ rng, int Np, int K, int id_bits, float qs, float qmax,
                int* __restrict__ pidx, unsigned char* __restrict__ pok,
                int* __restrict__ key_ji, int* __restrict__ theta) {
  __shared__ __align__(16) float rows[CH * 16];
  __shared__ float red[CH / 32][6];
  const int b = blockIdx.x, t = threadIdx.x;
  const int rank = b * CH + t;                    // < Np_pad: the table is padded
  const float* me = pack + (size_t)rank * 16;
  const float cx = me[0], cy = me[1], cz = me[2];
  const float lx = me[3], ly = me[4], lz = me[5];
  const float hx = me[6], hy = me[7], hz = me[8];
  const float own = me[9], orig = me[11];
  const bool val = me[10] > 0.5f;

  // The block's AABB union over its valid lanes.
  float u[6] = {val ? lx : BIG, val ? ly : BIG, val ? lz : BIG,
                val ? hx : -BIG, val ? hy : -BIG, val ? hz : -BIG};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    u[a] = warp_min(u[a]);
    u[3 + a] = warp_max(u[3 + a]);
  }
  if ((t & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) red[t >> 5][a] = u[a];
  }
  __syncthreads();
  float blo[3], bhi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    blo[a] = red[0][a];
    bhi[a] = red[0][3 + a];
#pragma unroll
    for (int w = 1; w < CH / 32; ++w) {
      blo[a] = fminf(blo[a], red[w][a]);
      bhi[a] = fmaxf(bhi[a], red[w][3 + a]);
    }
  }

  const int mask = (1 << id_bits) - 1;
  int best[MAXK];
#pragma unroll
  for (int s = 0; s < MAXK; ++s) best[s] = IMAX;
  int kth = IMAX;

  const int c0 = rng[2 * b], c1 = rng[2 * b + 1];
  for (int ch = c0; ch < c1; ++ch) {
    const float* cb = cab + (size_t)ch * 6;
    const bool guard = cb[0] <= bhi[0] && blo[0] <= cb[3] && cb[1] <= bhi[1] &&
                       blo[1] <= cb[4] && cb[2] <= bhi[2] && blo[2] <= cb[5];
    if (!guard) continue;                         // uniform across the block
    __syncthreads();                              // the previous chunk is read
    const float4* src = reinterpret_cast<const float4*>(pack + (size_t)ch * CH * 16);
    float4* dst = reinterpret_cast<float4*>(rows);
    for (int i = t; i < CH * 4; i += CH) dst[i] = src[i];
    __syncthreads();
    if (!val) continue;
    for (int r = 0; r < CH; ++r) {
      const float* o = rows + r * 16;
      const bool over = o[3] <= hx && lx <= o[6] && o[4] <= hy && ly <= o[7] &&
                        o[5] <= hz && lz <= o[8];
      if (!over || !(o[10] > 0.5f) || o[9] == own || o[11] == orig) continue;
      const float dx = o[0] - cx, dy = o[1] - cy, dz = o[2] - cz;
      float d2 = dx * dx;
      d2 = d2 + dy * dy;
      d2 = d2 + dz * dz;
      const int q = (int)fminf(d2 * qs, qmax);
      int v = (q << id_bits) | ((int)o[11] & mask);
      if (v >= kth) continue;
#pragma unroll
      for (int s = 0; s < MAXK; ++s) {
        if (s < K) {
          const int lo = min(best[s], v);
          v = max(best[s], v);
          best[s] = lo;
        }
      }
#pragma unroll
      for (int s = 0; s < MAXK; ++s)
        if (s == K - 1) kth = best[s];
    }
  }

  if (rank >= Np) return;
  const int i = (int)orig;
#pragma unroll
  for (int s = 0; s < MAXK; ++s) {
    if (s < K) {
      const int key = best[s];
      pidx[(size_t)i * K + s] = key & mask;
      pok[(size_t)i * K + s] = key != IMAX;
      key_ji[(size_t)i * K + s] = (key & ~mask) | i;
    }
  }
  theta[i] = kth;
}

}  // namespace

extern "C" int surtr_broadphase_exact(const float* pack, const float* cab, const int* rng, int Np,
                                      int NB, int K, int id_bits, float qs, float qmax,
                                      int* pidx, unsigned char* pok, int* key_ji, int* theta,
                                      void* stream) {
  if (K < 1 || K > MAXK || id_bits < 1 || id_bits > 30) return (int)cudaErrorInvalidValue;
  if (NB > 0)
    bp_exact_kernel<<<NB, CH, 0, (cudaStream_t)stream>>>(pack, cab, rng, Np, K, id_bits, qs,
                                                         qmax, pidx, pok, key_ji, theta);
  return (int)cudaGetLastError();
}
