// Connected components of triangle soups, one per candidate (kernel B3).
//
// Replaces: surtr_tpu/ops/labels_pallas.py `_labels_kernel` (wrapper
// `tri_soup_components_batch_pallas`). Semantics of the plain
// surtr_tpu_torch/ops/labels.py: corners quantized as rint(x / tol) (round
// half to even, a true division, as jnp.round(corners / tol)); triangles
// adjacent when any corner pair has equal quantized triples; at most
// `rounds` rounds of min-label relaxation then pointer jumping
// (lab <- min(lab, lab[lab])); label = min triangle index of the component,
// invalid triangles get T.
//
// What bounds it on the card: per candidate the T x T corner test (9
// corner compares a pair) and the dependent rounds, i.e. the latency of one
// candidate's chain; the input is 2.3 KB a candidate at T = 64.
// Design: a thread owns a triangle and a warp 32 of them; the warps read
// the candidate's 9T floats with 16-byte loads, issued with the mask's
// before any wait, and quantize them into shared memory. Each corner gets a
// 64-bit key (21 bits a coordinate), kept in registers by its owner. Row i
// of the adjacency is built by ballot, four rows at a time (independent
// tests whose latencies overlap): lane l of warp w tests its triangle
// 32 w + l against row i's keys (a broadcast read), and the ballot is row
// i's word w. A key match is exact when every quantized coordinate of the
// soup fits 21 bits (a vote); otherwise it is confirmed by the triple
// compare. Invalid rows and columns and an all-invalid candidate are
// skipped by uniform branches. Each round is the relax over the row's set
// bits (four labels at a time), then the jump, reads before writes; the
// candidate stops at the first round that changes no label (a round is a
// function of the labels alone, so the remaining rounds are the identity).
// One block a candidate, a warp per 32 triangles (1 <= T <= 1024; the
// general variant below beyond), the
// words in shared memory, block barriers. (At T = 64 the block of two warps
// measured faster than one warp owning two triangles a lane: PERF.md.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// A corner's 64-bit key: the low 21 bits of each quantized coordinate.
// Equal corners have equal keys; where every coordinate of the soup lies in
// [-2^20, 2^20) the converse holds too, and a key match is exact.
__device__ __forceinline__ unsigned long long corner_key(int x, int y, int z) {
  constexpr unsigned M = 0x1FFFFFu;
  return ((unsigned long long)((unsigned)x & M) << 42) |
         ((unsigned long long)((unsigned)y & M) << 21) | (unsigned long long)((unsigned)z & M);
}

__device__ __forceinline__ bool key_range(int x) { return x >= -(1 << 20) && x < (1 << 20); }

__device__ __forceinline__ int quantize(float x, float tol) { return (int)rintf(__fdiv_rn(x, tol)); }

// The soup's 9T floats by `nt` threads (nt >= T): every load in flight
// before the first use, 16-byte loads where the soup is 16-byte aligned.
struct Corners {
  float4 v[3];
};

__device__ __forceinline__ Corners load_corners(const float* cb, int T, int tid, int nt) {
  Corners c;
  const int n4 = (9 * T) >> 2;
  const bool al = (reinterpret_cast<uintptr_t>(cb) & 15) == 0;
#pragma unroll
  for (int f = 0; f < 3; ++f) {  // 9T / 4 <= 3 nt
    const int i = tid + nt * f;
    if (i < n4) {
      if (al) c.v[f] = __ldg(reinterpret_cast<const float4*>(cb) + i);
      else c.v[f] = make_float4(__ldg(cb + 4 * i), __ldg(cb + 4 * i + 1), __ldg(cb + 4 * i + 2),
                                __ldg(cb + 4 * i + 3));
    }
  }
  return c;
}

// The loaded floats quantized into q (and the last 9T % 4 floats).
__device__ __forceinline__ void store_quantized(const Corners& c, const float* cb, int T, int* q,
                                                float tol, int tid, int nt) {
  const int n4 = (9 * T) >> 2;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const int i = tid + nt * f;
    if (i < n4) {
      q[4 * i + 0] = quantize(c.v[f].x, tol);
      q[4 * i + 1] = quantize(c.v[f].y, tol);
      q[4 * i + 2] = quantize(c.v[f].z, tol);
      q[4 * i + 3] = quantize(c.v[f].w, tol);
    }
  }
  for (int i = 4 * n4 + tid; i < 9 * T; i += nt) q[i] = quantize(cb[i], tol);
}

// Triangle t's quantized corners into registers and its keys into shared
// memory; false where a coordinate does not fit a key exactly.
__device__ __forceinline__ bool own_corners(const int* q, unsigned long long* keys, int t,
                                            int (&my)[9], unsigned long long (&mk)[3]) {
  bool in_range = true;
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    my[e] = q[t * 9 + e];
    in_range &= key_range(my[e]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mk[c] = corner_key(my[3 * c], my[3 * c + 1], my[3 * c + 2]);
    keys[t * 3 + c] = mk[c];
  }
  return in_range;
}

// Any of the 3 x 3 corner key pairs equal.
__device__ __forceinline__ bool keys_meet(const unsigned long long (&mk)[3],
                                          const unsigned long long (&rk)[3]) {
  bool m = false;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) m |= mk[c] == rk[a];
  return m;
}

// Any corner of triangle `mine` (9 ints and 3 keys in registers) equal to
// any corner of `row` (9 ints in shared memory, keys rk): a key match
// confirmed by the triples.
__device__ __forceinline__ bool corners_meet(const int (&mine)[9],
                                             const unsigned long long (&mk)[3], const int* row,
                                             const unsigned long long (&rk)[3]) {
  if (!keys_meet(mk, rk)) return false;
  bool hit = false;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      hit |= (mine[c * 3] == row[a * 3]) & (mine[c * 3 + 1] == row[a * 3 + 1]) &
             (mine[c * 3 + 2] == row[a * 3 + 2]);
  return hit;
}

// The words of the rows set in `rows` (row i = base + bit), four rows at a
// time: the calling warp's lanes test their own triangles (valid `vt`)
// against each row, and `keep(i, word)` receives each row's ballot.
template <typename Keep>
__device__ __forceinline__ void build_rows(unsigned rows, int base,
                                           const unsigned long long* keys, const int* q,
                                           const int (&my)[9], const unsigned long long (&mk)[3],
                                           bool vt, bool exact, Keep keep) {
  while (rows) {
    int ii[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ii[u] = rows ? base + __ffs(rows) - 1 : -1;
      rows &= rows - 1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = max(ii[u], 0);
      const unsigned long long rk[3] = {keys[3 * i], keys[3 * i + 1], keys[3 * i + 2]};
      const bool hit = vt && (exact ? keys_meet(mk, rk) : corners_meet(my, mk, q + i * 9, rk));
      const unsigned word = __ballot_sync(FULL, hit);
      if (ii[u] >= 0) keep(ii[u], word);
    }
  }
}

// min(m, lab[j]) over the set bits j of `bits`, four at a time (a repeat
// where fewer are left).
__device__ __forceinline__ int relax_word(int m, unsigned bits, const int* lab) {
  while (bits) {
    const int j0 = __ffs(bits) - 1;
    bits &= bits - 1;
    const int j1 = bits ? __ffs(bits) - 1 : j0;
    bits &= bits - 1;
    const int j2 = bits ? __ffs(bits) - 1 : j0;
    bits &= bits - 1;
    const int j3 = bits ? __ffs(bits) - 1 : j0;
    bits &= bits - 1;
    m = min(m, min(min(lab[j0], lab[j1]), min(lab[j2], lab[j3])));
  }
  return m;
}

// One block a candidate, thread t owns triangle t, warp w builds word w of
// every valid row. At most 64 registers a thread, so T = 1024 launches.
__global__ void __launch_bounds__(1024)
labels_block_kernel(const float* __restrict__ corners, const unsigned char* __restrict__ valid,
                    int* __restrict__ labels_out, int T, long long cstride, int rounds,
                    float tol) {
  extern __shared__ int smem[];
  const int NW = (T + 31) >> 5;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // 3T
  int* q = smem + 6 * T;                                         // 9T
  int* lab = q + 9 * T;                                          // T
  unsigned* adj = reinterpret_cast<unsigned*>(lab + T);          // T * NW
  unsigned* vws = adj + (size_t)T * NW;                          // NW
  const int b = blockIdx.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  int* ob = labels_out + (size_t)b * T;

  const float* cb = corners + (size_t)b * cstride;
  const Corners cv = load_corners(cb, T, t, blockDim.x);
  const bool vt = t < T && valid[(size_t)b * T + t] != 0;
  const unsigned vw = __ballot_sync(FULL, vt);
  if (lane == 0) vws[w] = vw;
  if (!__syncthreads_or(vt)) {
    if (t < T) ob[t] = T;
    return;
  }
  store_quantized(cv, cb, T, q, tol, t, blockDim.x);
  __syncthreads();
  int my[9] = {};
  unsigned long long mk[3] = {};
  bool in_range = true;
  if (t < T) {
    in_range = own_corners(q, keys, t, my, mk);
    lab[t] = vt ? t : T;
  }
  const bool exact = __syncthreads_and(in_range);
  if (vw != 0u) {
    for (int wi = 0; wi < NW; ++wi)
      build_rows(vws[wi], 32 * wi, keys, q, my, mk, vt, exact, [&](int i, unsigned word) {
        if (lane == 0) adj[(size_t)i * NW + w] = word;
      });
  } else if (lane == 0) {
    for (int i = 0; i < T; ++i) adj[(size_t)i * NW + w] = 0u;
  }
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    int nl = T;
    bool changed = false;
    if (vt) {
      nl = lab[t];
      for (int wj = 0; wj < NW; ++wj)
        nl = relax_word(nl, adj[(size_t)t * NW + wj], lab + 32 * wj);
    }
    __syncthreads();
    if (vt) {
      changed |= nl != lab[t];
      lab[t] = nl;
    }
    __syncthreads();
    if (vt) {  // jump: lab <- min(lab, lab[lab])
      const int l = lab[t];
      nl = min(l, lab[l]);
    }
    __syncthreads();
    if (vt) {
      changed |= nl != lab[t];
      lab[t] = nl;
    }
    if (!__syncthreads_or(changed)) break;
  }
  if (t < T) ob[t] = vt ? lab[t] : T;
}

// Words of one soup's state in the general variant: keys (3T 64-bit), the
// quantized corners (9T), two label buffers (2T), the valid words (NW) and
// the adjacency rows (T x NW words), rounded up to an even count.
__host__ __device__ inline long long general_words(int T) {
  const long long NW = (T + 31) / 32;
  return (17LL * T + NW + (long long)T * NW + 1) / 2 * 2;
}

// The general variant, for T > 1024: a block of 1024 threads a soup, each
// thread taking triangles t, t + 1024, ...; the soup's state in the block's
// slice of a device scratch (general_words(T) words), the block walking
// soups b, b + gridDim.x, ... Adjacency words by ballot as above (a warp a
// (valid row, word) pair); each round relaxes into the second label buffer,
// then jumps back into the first from it, and the soup stops at the first
// round that changes no label.
__global__ void __launch_bounds__(1024)
labels_general_kernel(const float* __restrict__ corners, const unsigned char* __restrict__ valid,
                      int* __restrict__ labels_out, int N, int T, long long cstride, int rounds,
                      float tol, int* __restrict__ scratch) {
  const int NW = (T + 31) >> 5;
  int* const base = scratch + (size_t)blockIdx.x * general_words(T);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base);   // 3T
  int* q = base + 6 * T;                                                   // 9T
  int* lab = q + 9 * T;                                                    // T
  int* lab2 = lab + T;                                                     // T
  unsigned* vws = reinterpret_cast<unsigned*>(lab2 + T);                   // NW
  unsigned* adj = vws + NW;                                                // T * NW
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5;
  auto vbit = [&](int t) { return ((vws[t >> 5] >> (t & 31)) & 1u) != 0u; };
  for (int b = blockIdx.x; b < N; b += gridDim.x) {
    const float* cb = corners + (size_t)b * cstride;
    const unsigned char* vb = valid + (size_t)b * T;
    int* ob = labels_out + (size_t)b * T;
    bool any = false;
    for (int w = warp; w < NW; w += nwarps) {
      const int t = 32 * w + lane;
      const unsigned word = __ballot_sync(FULL, t < T && vb[t] != 0);
      if (lane == 0) vws[w] = word;
      any |= word != 0u;
    }
    for (int i = tid; i < 9 * T; i += nt) q[i] = quantize(cb[i], tol);
    if (!__syncthreads_or(any)) {
      for (int t = tid; t < T; t += nt) ob[t] = T;
      __syncthreads();
      continue;
    }
    bool in_range = true;
    for (int t = tid; t < T; t += nt) {
      int my[9];
      unsigned long long mk[3];
      in_range &= own_corners(q, keys, t, my, mk);
      lab[t] = vbit(t) ? t : T;
      lab2[t] = lab[t];
    }
    const bool exact = __syncthreads_and(in_range);
    for (long long x = warp; x < (long long)T * NW; x += nwarps) {
      const int i = (int)(x / NW), w = (int)(x - (long long)i * NW);
      if (!vbit(i)) continue;                     // the warp's row: uniform
      const int j = 32 * w + lane;
      bool hit = false;
      if (j < T && vbit(j)) {
        int my[9];
#pragma unroll
        for (int e = 0; e < 9; ++e) my[e] = q[j * 9 + e];
        const unsigned long long mk[3] = {keys[3 * j], keys[3 * j + 1], keys[3 * j + 2]};
        const unsigned long long rk[3] = {keys[3 * i], keys[3 * i + 1], keys[3 * i + 2]};
        hit = exact ? keys_meet(mk, rk) : corners_meet(my, mk, q + i * 9, rk);
      }
      const unsigned word = __ballot_sync(FULL, hit);
      if (lane == 0) adj[(size_t)i * NW + w] = word;
    }
    __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      bool changed = false;
      for (int t = tid; t < T; t += nt) {
        if (!vbit(t)) continue;
        int nl = lab[t];
        for (int wj = 0; wj < NW; ++wj) nl = relax_word(nl, adj[(size_t)t * NW + wj], lab + 32 * wj);
        lab2[t] = nl;
      }
      __syncthreads();
      for (int t = tid; t < T; t += nt) {
        if (!vbit(t)) continue;
        const int l = lab2[t];
        const int nl = min(l, lab2[l]);          // jump: lab <- min(lab, lab[lab])
        changed |= nl != lab[t];
        lab[t] = nl;
      }
      if (!__syncthreads_or(changed)) break;
    }
    for (int t = tid; t < T; t += nt) ob[t] = vbit(t) ? lab[t] : T;
    __syncthreads();                              // the slice is read before the next soup
  }
}

}  // namespace

extern "C" long long surtr_labels_general_words(int T) { return general_words(T); }

// corners: candidate b's (T, 3, 3) floats are contiguous from
// corners + b * cstride. T <= 1024 takes the block kernel; T > 1024 the
// general one on `blocks` CTAs, with `scratch` holding blocks *
// general_words(T) ints (labels_cuda.general_words).
extern "C" int surtr_labels(const float* corners, long long cstride, const unsigned char* valid,
                            int* labels, int N, int T, int rounds, float tol, int* scratch,
                            int blocks, void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (T > 1024) {
    if (scratch == nullptr || blocks < 1) return (int)cudaErrorInvalidValue;
    labels_general_kernel<<<blocks, 1024, 0, s>>>(corners, valid, labels, N, T, cstride, rounds,
                                                  tol, scratch);
    return (int)cudaGetLastError();
  }
  const int NW = (T + 31) / 32;
  const size_t smem = ((size_t)16 * T + (size_t)T * NW + NW) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        labels_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  labels_block_kernel<<<N, NW * 32, smem, s>>>(corners, valid, labels, T, cstride, rounds, tol);
  return (int)cudaGetLastError();
}
