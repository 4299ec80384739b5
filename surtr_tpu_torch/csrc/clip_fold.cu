// Batched K-plane fold of padded convex polytopes (kernel B1).
//
// Replaces: surtr_tpu/ops/clip_pallas.py `_clip_kernel` (wrapper
// `clip_planes_batch_pallas`), the TPU VMEM plane fold. Semantics are those
// of the plain fold in surtr_tpu_torch/ops/clip.py (= the JAX package's
// `clip_poly_plane` folded over the plane list): per face Sutherland-Hodgman
// emission [v if kept][cut point if the edge crosses], truncated to S; cap
// face from <= 3 candidates per face, ordered by atan2 about their centroid,
// bitwise duplicates dropped, truncated to S, written to the first free
// slot; fewer than 4 live faces clears the polytope. (The TPU kernel emits
// a rotation of each loop and orders caps by a pseudo-angle; the cyclic
// order and the polytope are the same.)
//
// What bounds it on the card: not bytes (one polytope is ~5 KB at F=26,
// S=16 and is read and written once) but the serial dependency of the fold:
// every plane step depends on the previous one, with two block barriers per
// step and a short serial cap assembly. Design: one block per polytope, one
// thread per face, the whole polytope state in shared memory for all K
// planes (no device-memory round trip between steps); the cap is built only
// when some vertex is removed (__syncthreads_or), so the many no-cut tail
// planes of a Voronoi fold cost one distance pass.
//
// Exactness: the cut point (a*s_b - b*s_a)/(s_b - s_a) must be bitwise
// sign-symmetric so the two faces sharing an edge produce the same point
// (the cap dedup relies on it). The file is built with -fmad=false, so no
// multiply-add is contracted into an FMA.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CAPS = 3;

struct Smem {
  float* fv;      // F*S*3 current polytope
  float* ofv;     // F*S*3 emission scratch
  float* pl;      // F*4
  int* nv;        // F
  int* onv;       // F
  float* pool;    // F*CAPS*3 cap candidates
  int* pool_n;    // F
  float* key;     // F*CAPS
  float* srt;     // F*CAPS*3 candidates in angle order
  float* misc;    // 8: centroid(3), u(3), v(3) (uses 9 -> 12 reserved)
  int* imisc;     // 4: cnt
};

__host__ __device__ inline size_t smem_bytes(int F, int S) {
  size_t f = 0;
  f += (size_t)F * S * 3 * 2;     // fv, ofv
  f += (size_t)F * 4;             // pl
  f += (size_t)F * CAPS * 3 * 2;  // pool, srt
  f += (size_t)F * CAPS;          // key
  f += 12;                        // misc
  size_t i = (size_t)F * 3 + 4;   // nv, onv, pool_n, imisc
  return (f + i) * 4;
}

__device__ __forceinline__ float sdist(const float* v, float nx, float ny,
                                       float nz, float d) {
  return ((v[0] * nx + v[1] * ny) + v[2] * nz) + d;
}

__global__ void clip_fold_kernel(const float* __restrict__ fv_in,
                                 const int* __restrict__ nv_in,
                                 const float* __restrict__ pl_in,
                                 const float* __restrict__ cuts,
                                 const unsigned char* __restrict__ cmask,
                                 float* __restrict__ fv_out,
                                 int* __restrict__ nv_out,
                                 float* __restrict__ pl_out, int F, int S,
                                 int K, float tol) {
  extern __shared__ float sm_raw[];
  Smem sm;
  {
    float* p = sm_raw;
    sm.fv = p; p += F * S * 3;
    sm.ofv = p; p += F * S * 3;
    sm.pl = p; p += F * 4;
    sm.pool = p; p += F * CAPS * 3;
    sm.srt = p; p += F * CAPS * 3;
    sm.key = p; p += F * CAPS;
    sm.misc = p; p += 12;
    int* q = reinterpret_cast<int*>(p);
    sm.nv = q; q += F;
    sm.onv = q; q += F;
    sm.pool_n = q; q += F;
    sm.imisc = q;
  }
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int FS3 = F * S * 3;

  for (int j = tid; j < FS3; j += blockDim.x) sm.fv[j] = fv_in[(size_t)b * FS3 + j];
  for (int j = tid; j < F * 4; j += blockDim.x) sm.pl[j] = pl_in[(size_t)b * F * 4 + j];
  for (int j = tid; j < F; j += blockDim.x) sm.nv[j] = nv_in[(size_t)b * F + j];
  __syncthreads();

  const int f = tid;
  const bool own = f < F;

  for (int k = 0; k < K; ++k) {
    if (!cmask[(size_t)b * K + k]) continue;  // masked plane: no-op
    const float* c = cuts + ((size_t)b * K + k) * 4;
    const float nx = c[0], ny = c[1], nz = c[2], d = c[3];

    // Pass 1: does this plane remove a vertex of this face / the polytope?
    bool touched = false;
    int n = 0;
    float* loop = nullptr;
    if (own) {
      n = sm.nv[f];
      loop = sm.fv + f * S * 3;
      for (int s = 0; s < n; ++s)
        touched |= sdist(loop + s * 3, nx, ny, nz, d) > tol;
    }
    const bool any_removed = __syncthreads_or(touched);

    // Pass 2: emission and cap candidates, one face per thread.
    if (own) {
      float* out = sm.ofv + f * S * 3;
      float* pool = sm.pool + f * CAPS * 3;
      int cnt = 0, pc = 0;
      for (int s = 0; s < n; ++s) {
        const float* v = loop + s * 3;
        const float* vn = loop + ((s + 1 == n) ? 0 : s + 1) * 3;
        const float ds = sdist(v, nx, ny, nz, d);
        const float dn = sdist(vn, nx, ny, nz, d);
        const bool kept = ds <= tol;
        const bool cross = (ds < -tol && dn > tol) || (ds > tol && dn < -tol);
        const float den = dn - ds;
        const float safe = fabsf(den) > 1e-30f ? den : 1.0f;
        float p[3];
        for (int a = 0; a < 3; ++a) p[a] = (v[a] * dn - vn[a] * ds) / safe;
        if (kept) {
          if (cnt < S) for (int a = 0; a < 3; ++a) out[cnt * 3 + a] = v[a];
          ++cnt;
        }
        if (cross) {
          if (cnt < S) for (int a = 0; a < 3; ++a) out[cnt * 3 + a] = p[a];
          ++cnt;
        }
        const bool inplane = fabsf(ds) <= tol && touched;
        if (any_removed && (cross || inplane)) {
          if (pc < CAPS)
            for (int a = 0; a < 3; ++a) pool[pc * 3 + a] = cross ? p[a] : v[a];
          ++pc;
        }
      }
      const int n_out = cnt < S ? cnt : S;
      for (int j = n_out * 3; j < S * 3; ++j) out[j] = 0.0f;
      sm.onv[f] = n_out >= 3 ? n_out : 0;
      sm.pool_n[f] = pc < CAPS ? pc : CAPS;
    }
    __syncthreads();

    if (any_removed) {
      // Centroid of the candidates (pool order) and the in-plane basis.
      if (tid == 0) {
        float sx = 0.f, sy = 0.f, sz = 0.f;
        int cnt = 0;
        for (int g = 0; g < F; ++g)
          for (int q = 0; q < sm.pool_n[g]; ++q) {
            const float* pt = sm.pool + (g * CAPS + q) * 3;
            sx += pt[0]; sy += pt[1]; sz += pt[2];
            ++cnt;
          }
        const float fc = (float)(cnt > 1 ? cnt : 1);
        sm.misc[0] = sx / fc; sm.misc[1] = sy / fc; sm.misc[2] = sz / fc;
        sm.imisc[0] = cnt;
        const float ln = fmaxf(sqrtf((nx * nx + ny * ny) + nz * nz), 1e-30f);
        const float ux_n = nx / ln, uy_n = ny / ln, uz_n = nz / ln;
        const float ax = fabsf(ux_n), ay = fabsf(uy_n), az = fabsf(uz_n);
        // argmin |n| (first of ties) -> one-hot e; u = e x n; v = n x u.
        int axis = 0;
        if (ay < ax) axis = 1;
        if (az < (axis == 0 ? ax : ay)) axis = 2;
        const float ex = axis == 0, ey = axis == 1, ez = axis == 2;
        float ux = ey * uz_n - ez * uy_n;
        float uy = ez * ux_n - ex * uz_n;
        float uz = ex * uy_n - ey * ux_n;
        const float ul = fmaxf(sqrtf((ux * ux + uy * uy) + uz * uz), 1e-30f);
        ux /= ul; uy /= ul; uz /= ul;
        sm.misc[3] = ux; sm.misc[4] = uy; sm.misc[5] = uz;
        sm.misc[6] = uy_n * uz - uz_n * uy;
        sm.misc[7] = uz_n * ux - ux_n * uz;
        sm.misc[8] = ux_n * uy - uy_n * ux;
      }
      __syncthreads();
      if (own) {
        const float cx = sm.misc[0], cy = sm.misc[1], cz = sm.misc[2];
        for (int q = 0; q < CAPS; ++q) {
          float kv = INFINITY;
          if (q < sm.pool_n[f]) {
            const float* pt = sm.pool + (f * CAPS + q) * 3;
            const float rx = pt[0] - cx, ry = pt[1] - cy, rz = pt[2] - cz;
            const float pu = (rx * sm.misc[3] + ry * sm.misc[4]) + rz * sm.misc[5];
            const float pv = (rx * sm.misc[6] + ry * sm.misc[7]) + rz * sm.misc[8];
            kv = atan2f(pv, pu);
          }
          sm.key[f * CAPS + q] = kv;
        }
      }
      __syncthreads();
      // Stable rank by (key, flat index) -> angle-sorted candidate list.
      if (own) {
        for (int q = 0; q < sm.pool_n[f]; ++q) {
          const int j = f * CAPS + q;
          const float kj = sm.key[j];
          int r = 0;
          for (int g = 0; g < F; ++g)
            for (int h = 0; h < sm.pool_n[g]; ++h) {
              const int i = g * CAPS + h;
              const float ki = sm.key[i];
              r += (ki < kj) || (ki == kj && i < j);
            }
          for (int a = 0; a < 3; ++a) sm.srt[r * 3 + a] = sm.pool[j * 3 + a];
        }
      }
      __syncthreads();
      // Dedup adjacent bitwise duplicates, truncate to S, place the cap.
      if (tid == 0) {
        const int cnt = sm.imisc[0];
        int first_free = -1;
        for (int g = 0; g < F; ++g)
          if (sm.onv[g] == 0) { first_free = g; break; }
        int ncap = 0;
        float* cap = sm.ofv + (first_free < 0 ? 0 : first_free) * S * 3;
        // Count first so a cap that cannot be placed never overwrites a face.
        for (int r = 0; r < cnt; ++r) {
          const float* p = sm.srt + r * 3;
          const bool dup = r > 0 && p[0] == p[-3] && p[1] == p[-2] && p[2] == p[-1];
          if (!dup) ++ncap;
        }
        ncap = ncap < S ? ncap : S;
        if (ncap >= 3 && first_free >= 0) {
          int w = 0;
          for (int r = 0; r < cnt && w < ncap; ++r) {
            const float* p = sm.srt + r * 3;
            const bool dup = r > 0 && p[0] == p[-3] && p[1] == p[-2] && p[2] == p[-1];
            if (dup) continue;
            for (int a = 0; a < 3; ++a) cap[w * 3 + a] = p[a];
            ++w;
          }
          for (int j = ncap * 3; j < S * 3; ++j) cap[j] = 0.0f;
          sm.onv[first_free] = ncap;
          sm.pl[first_free * 4 + 0] = nx;
          sm.pl[first_free * 4 + 1] = ny;
          sm.pl[first_free * 4 + 2] = nz;
          sm.pl[first_free * 4 + 3] = d;
        }
      }
      __syncthreads();
    }

    // Commit the step; fewer than 4 live faces clears the polytope.
    const int live = __syncthreads_count(own && sm.onv[f] >= 3);
    if (own) {
      const float* src = sm.ofv + f * S * 3;
      float* dst = sm.fv + f * S * 3;
      for (int j = 0; j < S * 3; ++j) dst[j] = src[j];
      sm.nv[f] = live >= 4 ? sm.onv[f] : 0;
    }
    __syncthreads();
  }

  for (int j = tid; j < FS3; j += blockDim.x) fv_out[(size_t)b * FS3 + j] = sm.fv[j];
  for (int j = tid; j < F * 4; j += blockDim.x) pl_out[(size_t)b * F * 4 + j] = sm.pl[j];
  for (int j = tid; j < F; j += blockDim.x) nv_out[(size_t)b * F + j] = sm.nv[j];
}

}  // namespace

extern "C" size_t surtr_clip_fold_smem(int F, int S) { return smem_bytes(F, S); }

extern "C" int surtr_clip_fold(const float* fv, const int* nv, const float* pl,
                               const float* cuts, const unsigned char* cmask,
                               float* ofv, int* onv, float* opl, int N, int F,
                               int S, int K, float tol, void* stream) {
  const size_t smem = smem_bytes(F, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        clip_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((F + 31) / 32) * 32;
  if (N > 0)
    clip_fold_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
        fv, nv, pl, cuts, cmask, ofv, onv, opl, F, S, K, tol);
  return (int)cudaGetLastError();
}
