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
// vertex variant below beyond), the
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

// Hash-table slots of the vertex variant: a power of two of at least 4T,
// so the table is at most three quarters full (3T corners).
__host__ __device__ inline int hash_slots(int T) {
  int h = 1;
  while (h < 4 * T) h <<= 1;
  return h;
}

// 4-byte words of one soup's state in the vertex variant: the quantized
// corners (9T), each corner's vertex id (3T), the vertices' minimum labels
// (3T, indexed by the vertex's first corner), two label buffers (2T) and
// the hash table (hash_slots(T)).
__host__ __device__ inline long long vertex_words(int T) {
  return 17LL * T + hash_slots(T);
}

__device__ __forceinline__ unsigned vertex_hash(int x, int y, int z) {
  unsigned long long k = (unsigned long long)(unsigned)x * 0x9E3779B97F4A7C15ull ^
                         (unsigned long long)(unsigned)y * 0xC2B2AE3D27D4EB4Full ^
                         (unsigned long long)(unsigned)z * 0x165667B19E3779F9ull;
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDull;
  k ^= k >> 33;
  return (unsigned)k;
}

// The vertex variant (T > 1024; any T): labels without the T x T
// adjacency. Two triangles are adjacent when they share a quantized corner,
// so one relax of the plain version is, per round: vmin[v] = the minimum of
// the old labels of the valid triangles with a corner at vertex v (shared
// atomicMin: min does not depend on order), then each valid triangle's
// relaxed label = the minimum of its three vmin (its own label among
// them), then the pointer jump lab <- min(lab, lab[lab]) over the relaxed
// labels. Reads are Jacobi (the old labels; a block barrier between the
// passes), the soup stops at the first round that changes no label, and
// `rounds` caps them: the plain version's labels bit for bit, also when the
// rounds stop before the labels close.
// Vertex ids: each valid triangle's corners go into an open-addressing hash
// table keyed by the quantized triple (linear probing, atomicCAS); a slot
// holds the index of the first corner that claimed it, and a corner whose
// triple equals that corner's (compared in full, so no key range applies)
// takes it as its vertex. Invalid triangles neither insert nor write vmin;
// a triangle's label doubles as its valid flag (T when invalid).
// Work: the 9T floats read once, 3T insertions, then per round 3 passes
// over the valid triangles (3 atomics, 3 gathers, 1 jump each): it grows
// with the corners, not with T^2. What bounds it: the soup's bytes set a
// floor of ~1.6 µs at (64, 2,048); the rounds' barriers and atomics run
// it at 9x that on the card (PERF.md). One CTA a soup (up to 1024 threads,
// triangles t, t + blockDim, ...), the state in shared memory where
// vertex_words(T) fits a CTA (SHARED, 172,032 B at T = 2,048), else in
// the block's slice of a device scratch, the block walking soups b,
// b + gridDim.x, ...
template <bool SHARED>
__global__ void __launch_bounds__(1024)
labels_vertex_kernel(const float* __restrict__ corners, const unsigned char* __restrict__ valid,
                     int* __restrict__ labels_out, int N, int T, long long cstride, int rounds,
                     float tol, int* __restrict__ scratch) {
  extern __shared__ int smem[];
  const int H = hash_slots(T);
  int* const q = SHARED ? smem : scratch + (size_t)blockIdx.x * vertex_words(T);  // 9T
  int* const vid = q + 9 * T;                                                    // 3T
  int* const vmin = vid + 3 * T;                                                 // 3T
  int* const lab = vmin + 3 * T;                                                 // T
  int* const lab2 = lab + T;                                                     // T
  int* const table = lab2 + T;                                                   // H
  const int tid = threadIdx.x, nt = blockDim.x;
  constexpr int NONE = 0x7fffffff;
  for (int b = blockIdx.x; b < N; b += gridDim.x) {
    const float* cb = corners + (size_t)b * cstride;
    const unsigned char* vb = valid + (size_t)b * T;
    int* ob = labels_out + (size_t)b * T;
    bool any = false;
    for (int t = tid; t < T; t += nt) {
      const bool v = vb[t] != 0;
      lab[t] = v ? t : T;
      any |= v;
    }
    for (int i = tid; i < 9 * T; i += nt) q[i] = quantize(__ldg(cb + i), tol);
    for (int h = tid; h < H; h += nt) table[h] = -1;
    if (!__syncthreads_or(any)) {           // no thread reads the state after this
      for (int t = tid; t < T; t += nt) ob[t] = T;
      continue;
    }
    for (int c = tid; c < 3 * T; c += nt) {
      if (lab[c / 3] == T) continue;
      const int x = q[3 * c], y = q[3 * c + 1], z = q[3 * c + 2];
      unsigned h = vertex_hash(x, y, z) & (unsigned)(H - 1);
      for (;;) {
        const int first = atomicCAS(&table[h], -1, c);
        if (first < 0) {
          vid[c] = c;
          break;
        }
        if (q[3 * first] == x && q[3 * first + 1] == y && q[3 * first + 2] == z) {
          vid[c] = first;
          break;
        }
        h = (h + 1) & (unsigned)(H - 1);
      }
      vmin[c] = NONE;
    }
    __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      for (int t = tid; t < T; t += nt) {
        const int l = lab[t];
        if (l == T) continue;
        atomicMin(&vmin[vid[3 * t]], l);
        atomicMin(&vmin[vid[3 * t + 1]], l);
        atomicMin(&vmin[vid[3 * t + 2]], l);
      }
      __syncthreads();
      for (int t = tid; t < T; t += nt) {
        if (lab[t] == T) continue;
        lab2[t] = min(min(vmin[vid[3 * t]], vmin[vid[3 * t + 1]]), vmin[vid[3 * t + 2]]);
      }
      __syncthreads();
      bool changed = false;
      for (int t = tid; t < T; t += nt) {
        const int l0 = lab[t];
        if (l0 == T) continue;
        const int l = lab2[t];
        const int nl = min(l, lab2[l]);      // jump: lab <- min(lab, lab[lab])
        changed |= nl != l0;
        lab[t] = nl;
        vmin[vid[3 * t]] = NONE;             // vmin is next read after the vote below
        vmin[vid[3 * t + 1]] = NONE;
        vmin[vid[3 * t + 2]] = NONE;
      }
      if (!__syncthreads_or(changed)) break;
    }
    for (int t = tid; t < T; t += nt) ob[t] = lab[t];
    __syncthreads();                         // the state is read before the next soup
  }
}

}  // namespace

extern "C" long long surtr_labels_vertex_bytes(int T) { return vertex_words(T) * 4; }

// corners: candidate b's (T, 3, 3) floats are contiguous from
// corners + b * cstride. The block kernel, 1 <= T <= 1024.
extern "C" int surtr_labels(const float* corners, long long cstride, const unsigned char* valid,
                            int* labels, int N, int T, int rounds, float tol, void* stream) {
  if (T < 1 || T > 1024) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const int NW = (T + 31) / 32;
  const size_t smem = ((size_t)16 * T + (size_t)T * NW + NW) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        labels_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  labels_block_kernel<<<N, NW * 32, smem, (cudaStream_t)stream>>>(corners, valid, labels, T,
                                                                  cstride, rounds, tol);
  return (int)cudaGetLastError();
}

// The vertex variant, any T >= 1: with scratch == nullptr one CTA a soup
// with the state in shared memory (vertex_words(T) * 4 bytes must fit a
// CTA); else `blocks` CTAs walking the soups, scratch holding blocks *
// vertex_words(T) ints (labels_cuda.vertex_bytes).
extern "C" int surtr_labels_vertex(const float* corners, long long cstride,
                                   const unsigned char* valid, int* labels, int N, int T,
                                   int rounds, float tol, int* scratch, int blocks, void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = T >= 1024 ? 1024 : (T + 31) / 32 * 32;
  if (scratch != nullptr) {
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    labels_vertex_kernel<false><<<blocks, threads, 0, s>>>(corners, valid, labels, N, T, cstride,
                                                          rounds, tol, scratch);
    return (int)cudaGetLastError();
  }
  const long long smem = vertex_words(T) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        labels_vertex_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  labels_vertex_kernel<true><<<N, threads, (size_t)smem, s>>>(corners, valid, labels, N, T,
                                                             cstride, rounds, tol, nullptr);
  return (int)cudaGetLastError();
}
