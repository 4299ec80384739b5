// Batched refit planes: tetra hull + zero-gap k-DOP slabs (kernel B4).
//
// Replaces: surtr_tpu/ops/refit_pallas.py `_refit_kernel` (wrapper
// `refit_planes_batch_pallas`). Semantics of the plain version in
// surtr_tpu_torch/ops/refit_cuda.py (tetra_hull + kdop_planes(gap=0)): per
// candidate the four greedy first-of-ties extreme points (max x, farthest
// from it, max triangle area, max tetra volume; masked points score NEG),
// the tetra's four face normals oriented outward against its centroid
// (|n| <= 1e-20 invalid, a zero normal), and for each normal the slab
// [max plane (n, -(max n.v + 0)); min plane (-n, min n.v - 0)] over the
// masked pool, a zero minimum taking -0 when any live support is -0. Output
// order [4 max; 4 min]; the mask also needs >= 4 live points.
//
// The pool is read from two spans: span A of pa = 3T points whose mask is
// ma[j / 3] (the mesh's corners: point j is corner j % 3 of triangle j / 3)
// and span B of pb points masked one by one (the cap vertices; a built
// pool is span B alone, T = 0). Pool index j < pa is in A, the rest in B.
//
// What bounds it on the card: reading the pool once (12 bytes and a mask
// byte a point) and the dependent chain of one candidate: the load round
// trip, the compaction, four argmax reductions each feeding the next
// score, the normals' correctly rounded roots and quotients, the support
// reductions. At the fracture's shapes the chain, not the 8.4 KB a
// candidate. Design: one block of two warps a candidate. The block stages
// its spans and their mask bytes into shared memory with 16-byte loads,
// four in flight a thread, and compacts the live points in pool order by
// ballot and popcount, four rounds and one barrier at a time, each point
// with its pool index (x, y, z, index: 16 bytes), so every later pass
// sweeps live points only, two an iteration. Each argmax pass reduces
// (value, compacted index), the lower index on ties, across a warp by two
// redux reductions (the largest float-order key, then the least index
// holding it) and across the two warps through shared memory; compaction
// keeps pool order, so the lower compacted index is the lower pool index,
// and the first masked point stands in when NEG beats every live score
// (all masked: pool index 0). Twelve lanes work out the twelve normal
// components at once. One sweep folds the four normals' max and min
// supports; they are reduced as float-order keys, -0 below +0. Pools are
// staged in chunks of RAW_PTS points; beyond COMP_SMEM_PTS points the
// compacted points go to a device scratch given by the wrapper. (One and
// four warps a candidate measured slower on the fracture's calls: PERF.md.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -3.4e38f;
constexpr float BIG = 3.4e38f;
constexpr int RAW_PTS = 1024;                 // points a staging chunk
constexpr int COMP_SMEM_PTS = 8192;           // compacted points in shared memory
constexpr int WPC = 2;                        // warps a candidate
constexpr int NT = 32 * WPC;                  // threads a candidate (a block)

struct Spans {
  const float* a;
  const unsigned char* ma;
  int pa;
  const float* b;
  const unsigned char* mb;
  int pb;
};

// The smaller, -0 below +0 (IEEE minimum on zeros), whatever the order.
__device__ __forceinline__ float min_n0(float a, float b) {
  return (b < a || (b == a && signbit(b))) ? b : a;
}

// n elements from global s to shared d by `nt` threads, four loads in
// flight a thread before the stores.
template <typename E>
__device__ __forceinline__ void copy_batched(const E* __restrict__ s, E* d, int n, int tid,
                                             int nt) {
  for (int base = tid; base < n; base += 4 * nt) {
    E v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (base + nt * b < n) v[b] = s[base + nt * b];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (base + nt * b < n) d[base + nt * b] = v[b];
  }
}

// n bytes from global src to shared dst by `nt` threads: 16-byte loads
// where both are 16-byte aligned, else 4-byte loads where 4-byte aligned,
// then single bytes for the rest.
__device__ __forceinline__ void stage(const void* src, int n, void* dst, int tid, int nt) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* d = static_cast<unsigned char*>(dst);
  const uintptr_t al = reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d);
  int done = 0;
  if ((al & 15) == 0) {
    copy_batched(reinterpret_cast<const uint4*>(s), reinterpret_cast<uint4*>(d), n >> 4, tid, nt);
    done = n & ~15;
  } else if ((al & 3) == 0) {
    copy_batched(reinterpret_cast<const unsigned*>(s), reinterpret_cast<unsigned*>(d), n >> 2,
                 tid, nt);
    done = n & ~3;
  }
  copy_batched(s + done, d + done, n - done, tid, nt);
}

// The 16-byte-aligned part of a span: its whole 16-byte blocks when source
// and destination are both 16-byte aligned, else none.
__device__ __forceinline__ int blocks16(const void* src, const void* dst, int n) {
  return ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) ? 0
                                                                                      : n >> 4;
}

// Four byte spans from global to shared memory by `nt` threads at once: the
// aligned spans' 16-byte blocks in one sweep (four loads in flight a thread
// before the stores), then the rest of each span by `stage`.
__device__ __forceinline__ void stage4(const void* s0, void* d0, int n0, const void* s1, void* d1,
                                       int n1, const void* s2, void* d2, int n2,
                                       const void* s3, void* d3, int n3, int tid, int nt) {
  const int m0 = blocks16(s0, d0, n0), m1 = blocks16(s1, d1, n1);
  const int m2 = blocks16(s2, d2, n2), m3 = blocks16(s3, d3, n3);
  const int e0 = m0, e1 = e0 + m1, e2 = e1 + m2, tot = e2 + m3;
  for (int base = tid; base < tot; base += 4 * nt) {
    uint4 v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = base + nt * b;
      if (i < tot) {
        const uint4* s = static_cast<const uint4*>(i < e0 ? s0 : i < e1 ? s1 : i < e2 ? s2 : s3);
        v[b] = __ldg(s + (i - (i < e0 ? 0 : i < e1 ? e0 : i < e2 ? e1 : e2)));
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = base + nt * b;
      if (i < tot) {
        uint4* d = static_cast<uint4*>(i < e0 ? d0 : i < e1 ? d1 : i < e2 ? d2 : d3);
        d[i - (i < e0 ? 0 : i < e1 ? e0 : i < e2 ? e1 : e2)] = v[b];
      }
    }
  }
  stage(static_cast<const unsigned char*>(s0) + 16 * m0, n0 - 16 * m0,
        static_cast<unsigned char*>(d0) + 16 * m0, tid, nt);
  stage(static_cast<const unsigned char*>(s1) + 16 * m1, n1 - 16 * m1,
        static_cast<unsigned char*>(d1) + 16 * m1, tid, nt);
  stage(static_cast<const unsigned char*>(s2) + 16 * m2, n2 - 16 * m2,
        static_cast<unsigned char*>(d2) + 16 * m2, tid, nt);
  stage(static_cast<const unsigned char*>(s3) + 16 * m3, n3 - 16 * m3,
        static_cast<unsigned char*>(d3) + 16 * m3, tid, nt);
}

// A float's bits as an unsigned key in the float order (-0 below +0).
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// First-of-ties argmax of score over the L compacted points: (value,
// compacted index) folded per thread in index order, across each warp by two
// reductions (the largest value, -0 read as +0 as the plain argmax ties
// them, then the least index holding it), then across the warps from the
// pass's shared slot (sk, si); every thread ends with the result.
template <typename Score>
__device__ __forceinline__ void cand_argmax(const float4* comp, int L, Score score, unsigned* sk,
                                            int* si, float& v, int& k) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  v = -INFINITY;
  k = 0x7fffffff;
  for (int i = tid; i < L; i += 2 * NT) {  // two points an iteration, folded in index order
    const bool two = i + NT < L;
    const float s0 = score(comp[i]);
    const float s1 = score(comp[two ? i + NT : i]);
    if (s0 > v) { v = s0; k = i; }
    if (two && s1 > v) { v = s1; k = i + NT; }
  }
  unsigned top = __reduce_max_sync(FULL, order_key(v + 0.0f));
  k = (int)__reduce_min_sync(FULL, order_key(v + 0.0f) == top ? (unsigned)k : 0x7fffffffu);
  if (lane == 0) { sk[w] = top; si[w] = k; }
  __syncthreads();
  top = sk[0];
  k = si[0];
#pragma unroll
  for (int i = 1; i < WPC; ++i)
    if (sk[i] > top || (sk[i] == top && si[i] < k)) { top = sk[i]; k = si[i]; }
  v = key_float(top);
}

// The picked point: the live winner, or the first masked point where NEG
// beats it (or ties it at a lower pool index); pool index 0 where no score
// exceeds -inf (non-finite scores, which the plain argmax also maps to 0).
__device__ __forceinline__ float4 pick_point(const float4* comp, float v, int k, int first_m,
                                             int Pv, const float* A, const float* B, int pa) {
  const int live_idx = k != 0x7fffffff ? __float_as_int(comp[k].w) : 0x7fffffff;
  int idx = -1;
  if (first_m < Pv && (NEG > v || (NEG == v && first_m < live_idx))) idx = first_m;
  else if (k == 0x7fffffff) idx = 0;
  if (idx < 0) return comp[k];
  const float* s = idx < pa ? A + 3 * (size_t)idx : B + 3 * (size_t)(idx - pa);
  return make_float4(s[0], s[1], s[2], 0.0f);
}

// Face (fa, fb, fc)'s unit normal, oriented away from `inner`; zero and
// not ok where its length is <= 1e-20 (tetra_hull's arithmetic, in order).
__device__ __forceinline__ void face_normal(const float (&fa)[3], const float (&fb)[3],
                                            const float (&fc)[3], const float (&inner)[3],
                                            float (&n)[3], bool& ok) {
  const float ux = fb[0] - fa[0], uy = fb[1] - fa[1], uz = fb[2] - fa[2];
  const float wx = fc[0] - fa[0], wy = fc[1] - fa[1], wz = fc[2] - fa[2];
  float nx = uy * wz - uz * wy, ny = uz * wx - ux * wz, nz = ux * wy - uy * wx;
  const float s = (nx * (inner[0] - fa[0]) + ny * (inner[1] - fa[1])) + nz * (inner[2] - fa[2]);
  if (s > 0.0f) { nx = -nx; ny = -ny; nz = -nz; }
  const float ln = __fsqrt_rn((nx * nx + ny * ny) + nz * nz);
  ok = ln > 1e-20f;
  const float den = fmaxf(ln, 1e-30f);
  n[0] = ok ? __fdiv_rn(nx, den) : 0.0f;
  n[1] = ok ? __fdiv_rn(ny, den) : 0.0f;
  n[2] = ok ? __fdiv_rn(nz, den) : 0.0f;
}

// Shared memory of one candidate, in float4s: the compacted points (unless
// they go to the scratch), one staging chunk and the mask bytes.
__host__ __device__ __forceinline__ int raw_f4(int Pv) {
  return (3 * (Pv < RAW_PTS ? Pv : RAW_PTS) + 3) / 4;
}
__host__ __device__ __forceinline__ int cand_f4(int Pv, int mask_bytes, bool scratch) {
  return (scratch ? 0 : Pv) + raw_f4(Pv) + (mask_bytes + 15) / 16;
}

// One candidate a block of WPC warps; twelve blocks an SM (at most 85
// registers a thread), so a fracture call's ~1,100 candidates run in one wave.
__global__ void __launch_bounds__(NT, 12)
refit_kernel(Spans sp, float4* __restrict__ scratch, float* __restrict__ planes_out,
             unsigned char* __restrict__ pmask_out) {
  extern __shared__ float4 dsm[];
  __shared__ int s_cnt[2][4][WPC];
  __shared__ int s_first[WPC];
  __shared__ unsigned s_key[4][WPC];
  __shared__ int s_idx[4][WPC];
  __shared__ unsigned s_sup[8][WPC];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int cand = blockIdx.x;
  const int pa = sp.pa, Pv = sp.pa + sp.pb, na = pa / 3;
  const float* A = sp.a + (size_t)cand * 3 * pa;
  const unsigned char* MA = sp.ma + (size_t)cand * na;
  const float* B = sp.b + (size_t)cand * 3 * sp.pb;
  const unsigned char* MB = sp.mb + (size_t)cand * sp.pb;
  float4* comp = scratch ? scratch + (size_t)cand * Pv : dsm;
  float* raw = reinterpret_cast<float*>(scratch ? dsm : dsm + Pv);
  unsigned char* smask =
      reinterpret_cast<unsigned char*>((scratch ? dsm : dsm + Pv) + raw_f4(Pv));

  // Stage the mask bytes with the first chunk of points, then the points
  // chunk by chunk, and compact the live points in pool order: four rounds
  // of NT points at a time, each warp's ballot counted, one barrier a group.
  int L = 0, first_m = Pv, grp = 0;
  for (int c0 = 0; c0 < Pv; c0 += RAW_PTS) {
    const int c1 = min(Pv, c0 + RAW_PTS);
    const int a1 = max(min(c1, pa), c0), b0 = max(c0, pa);
    stage4(A + 3 * (size_t)c0, raw, 12 * (a1 - c0), B + 3 * (size_t)(b0 - pa),
           raw + 3 * (b0 - c0), 12 * max(c1 - b0, 0), MA, smask, c0 ? 0 : na, MB, smask + na,
           c0 ? 0 : sp.pb, tid, NT);
    __syncthreads();
    for (int r0 = c0; r0 < c1; r0 += 4 * NT, ++grp) {
      bool live[4];
      unsigned bal[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = r0 + NT * u + tid;
        live[u] = false;
        if (j < c1) {
          live[u] = smask[j < pa ? j / 3 : na + j - pa] != 0;
          if (!live[u]) first_m = min(first_m, j);
        }
        bal[u] = __ballot_sync(FULL, live[u]);
        if (lane == 0) s_cnt[grp & 1][u][w] = __popc(bal[u]);
      }
      __syncthreads();
      int acc = L;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int pre = acc;
#pragma unroll
        for (int i = 0; i < WPC; ++i) {
          const int c = s_cnt[grp & 1][u][i];
          if (i < w) pre += c;
          acc += c;
        }
        if (live[u]) {
          const int j = r0 + NT * u + tid;
          const float* q = raw + 3 * (j - c0);
          comp[pre + __popc(bal[u] & ((1u << lane) - 1u))] =
              make_float4(q[0], q[1], q[2], __int_as_float(j));
        }
      }
      L = acc;
    }
    __syncthreads();
  }
  first_m = (int)__reduce_min_sync(FULL, (unsigned)first_m);
  if (lane == 0) s_first[w] = first_m;
  __syncthreads();
  first_m = s_first[0];
#pragma unroll
  for (int i = 1; i < WPC; ++i) first_m = min(first_m, s_first[i]);

  // The four dependent extreme-point passes.
  float4 P[4];
  float v;
  int k;
  cand_argmax(comp, L, [](float4 q) { return q.x; }, s_key[0], s_idx[0], v, k);
  P[0] = pick_point(comp, v, k, first_m, Pv, A, B, pa);
  {
    const float ax = P[0].x, ay = P[0].y, az = P[0].z;
    cand_argmax(comp, L, [=](float4 q) {
      const float dx = q.x - ax, dy = q.y - ay, dz = q.z - az;
      return (dx * dx + dy * dy) + dz * dz;
    }, s_key[1], s_idx[1], v, k);
  }
  P[1] = pick_point(comp, v, k, first_m, Pv, A, B, pa);
  {
    const float ax = P[0].x, ay = P[0].y, az = P[0].z;
    const float ex = P[1].x - ax, ey = P[1].y - ay, ez = P[1].z - az;
    cand_argmax(comp, L, [=](float4 q) {
      const float rx = q.x - ax, ry = q.y - ay, rz = q.z - az;
      const float cx = ey * rz - ez * ry, cy = ez * rx - ex * rz, cz = ex * ry - ey * rx;
      return (cx * cx + cy * cy) + cz * cz;
    }, s_key[2], s_idx[2], v, k);
  }
  P[2] = pick_point(comp, v, k, first_m, Pv, A, B, pa);
  {
    const float p0x = P[0].x, p0y = P[0].y, p0z = P[0].z;
    const float p1x = P[1].x, p1y = P[1].y, p1z = P[1].z;
    const float p2x = P[2].x, p2y = P[2].y, p2z = P[2].z;
    cand_argmax(comp, L, [=](float4 q) {
      const float ax = p0x - q.x, ay = p0y - q.y, az = p0z - q.z;
      const float bx = p1x - q.x, by = p1y - q.y, bz = p1z - q.z;
      const float gx = p2x - q.x, gy = p2y - q.y, gz = p2z - q.z;
      const float x = by * gz - bz * gy, y = bz * gx - bx * gz, z = bx * gy - by * gx;
      return (ax * x + ay * y) + az * z;
    }, s_key[3], s_idx[3], v, k);
  }
  P[3] = pick_point(comp, v, k, first_m, Pv, A, B, pa);

  // The tetra's outward unit normals: lane 3 f + c (f < 4, c < 3) of each
  // warp works out component c of face f's normal, then every lane reads
  // the twelve from their lanes (the same bits in every warp).
  const float p[4][3] = {{P[0].x, P[0].y, P[0].z}, {P[1].x, P[1].y, P[1].z},
                        {P[2].x, P[2].y, P[2].z}, {P[3].x, P[3].y, P[3].z}};
  float inner[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) inner[a] = (((p[0][a] + p[1][a]) + p[2][a]) + p[3][a]) * 0.25f;
  float n[4][3];
  bool ok[4];
  {
    const int fl = min(lane / 3, 3), cl = lane % 3;
    float fa[3], fb[3], fc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {  // faces (0 1 2), (0 1 3), (0 2 3), (1 2 3)
      fa[a] = fl == 3 ? p[1][a] : p[0][a];
      fb[a] = fl < 2 ? p[1][a] : p[2][a];
      fc[a] = fl == 0 ? p[2][a] : p[3][a];
    }
    float nl[3];
    bool okl;
    face_normal(fa, fb, fc, inner, nl, okl);
    const float mine = cl == 0 ? nl[0] : cl == 1 ? nl[1] : nl[2];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
#pragma unroll
      for (int c = 0; c < 3; ++c) n[f][c] = __shfl_sync(FULL, mine, 3 * f + c);
      ok[f] = __shfl_sync(FULL, okl, 3 * f);
    }
  }

  // One sweep: the four normals' max and min supports, as float-order keys
  // (-0 below +0, as min_n0) reduced across the warp, then the warps.
  float tmax[4], tmin[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) { tmax[f] = -BIG; tmin[f] = BIG; }
  for (int i = tid; i < L; i += 2 * NT) {  // two points an iteration
    const float4 q0 = comp[i];
    const float4 q1 = comp[i + NT < L ? i + NT : i];  // a repeat folds to the same
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float t0 = (q0.x * n[f][0] + q0.y * n[f][1]) + q0.z * n[f][2];
      const float t1 = (q1.x * n[f][0] + q1.y * n[f][1]) + q1.z * n[f][2];
      tmax[f] = fmaxf(tmax[f], fmaxf(t0, t1));
      tmin[f] = min_n0(tmin[f], min_n0(t0, t1));
    }
  }
  unsigned kmax[4], kmin[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    kmax[f] = __reduce_max_sync(FULL, order_key(tmax[f]));
    kmin[f] = __reduce_min_sync(FULL, order_key(tmin[f]));
  }
  if (lane == 0)
#pragma unroll
    for (int f = 0; f < 4; ++f) { s_sup[f][w] = kmax[f]; s_sup[4 + f][w] = kmin[f]; }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int i = 0; i < WPC; ++i) {
      kmax[f] = max(kmax[f], s_sup[f][i]);
      kmin[f] = min(kmin[f], s_sup[4 + f][i]);
    }
  if (w != 0) return;

  // Lane l writes float l of the candidate's (8, 4) planes.
  const int side = lane >> 4, f = (lane >> 2) & 3, c = lane & 3;
  float val = 0.0f;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    if (g == f) {
      if (c < 3) val = side ? -n[g][c] : n[g][c];
      else val = side ? key_float(kmin[g]) - 0.0f : -(key_float(kmax[g]) + 0.0f);
    }
  planes_out[(size_t)cand * 32 + lane] = val;
  if (lane < 8) {
    bool pm = false;
#pragma unroll
    for (int g = 0; g < 4; ++g) pm |= (g == (lane & 3)) && ok[g];
    pmask_out[(size_t)cand * 8 + lane] = pm && L >= 4;
  }
}

int launch(const Spans& sp, float4* scratch, float* planes, unsigned char* pmask, int N,
           cudaStream_t stream) {
  const int Pv = sp.pa + sp.pb;
  if (Pv < 1) return (int)cudaErrorInvalidValue;
  if (Pv > COMP_SMEM_PTS && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const size_t smem = (size_t)cand_f4(Pv, sp.pa / 3 + sp.pb, scratch != nullptr) *
                      sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        refit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  refit_kernel<<<N, NT, smem, stream>>>(sp, scratch, planes, pmask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int surtr_refit_smem_points() { return COMP_SMEM_PTS; }

// The pool from its parts: (N, T, 3, 3) triangles with (N, T) mask bytes,
// then (N, C, 3) cap vertices with (N, C) mask bytes.
extern "C" int surtr_refit_parts(const float* tris, const unsigned char* tri_mask, int T,
                                 const float* caps, const unsigned char* cap_mask, int C,
                                 float* planes, unsigned char* pmask, int N, void* scratch,
                                 void* stream) {
  const Spans sp{tris, tri_mask, 3 * T, caps, cap_mask, C};
  return launch(sp, static_cast<float4*>(scratch), planes, pmask, N, (cudaStream_t)stream);
}
