// Pooled triangle-soup clip (kernel B10).
//
// Replaces: surtr_tpu/ops/soup_clip_pallas.py `_soup_kernel` (wrapper
// `soup_clip_pooled_pallas`). Semantics of the plain
// surtr_tpu_torch/ops/soup_clip_cuda.py `soup_clip_pooled_reference`: every
// pooled lane is one triangle with its cell id, turned into a polygon of
// S = 8 slots and folded by each live plane of its cell (Sutherland-Hodgman
// with cyclic-run emission [rotated kept run, exit, enter]; exit and enter
// are sums over the slots; n_out = min(mcnt + ex + en, S); the in-plane
// drop rule; the multirun guard, counted; n_out < 3 becomes 0). Masked
// planes are no-ops; a cell id outside [0, C) reads no planes.
//
// The in-plane rule's context is per block of BN lanes, as the TPU kernel
// computes it (its grid step is a BN-lane block): for plane k of cell c it
// is true when any valid lane of cell c in the same block has an original
// corner with ((x*nx + y*ny) + z*nz) + d > tol and plane k is live. Blocks
// run in no order here, so a first launch ORs each lane's K-bit mask into a
// zeroed (P/BN, C, ceil(K/32)) table in global memory with atomicOr, and a
// second launch folds, one thread per lane, its polygon in registers
// through all K planes.
//
// What bounds it on the card: the bytes of the pool, about 150 a lane
// (triangle, ids, the 8-slot result), against the fold's float work, about
// 36 operations per slot per live plane of a live lane; the pools of the
// pipeline are mostly dead lanes (capacity over live pairs), so bytes bound
// it, at a microsecond or two, and launch latency and the serial plane
// loop of one thread dominate. A lane stops at the first live plane that
// finds its polygon empty. The planes of a cell are read by cell id (the
// TPU kernel gathered them with a one-hot matrix product); lanes of one
// cell are contiguous, so a warp mostly reads one row (broadcast). Built
// with -fmad=false, so every product and sum rounds as in the plain
// version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int S = 8;
constexpr int THREADS = 128;

__global__ void soup_ctx_kernel(const float* __restrict__ tri,
                                const unsigned char* __restrict__ valid,
                                const int* __restrict__ cell,
                                const float* __restrict__ planes,
                                const unsigned char* __restrict__ pmask,
                                unsigned* __restrict__ ctx, int P, int C, int K,
                                int BN, int W, float tol) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const int c = cell[i];
  if (!valid[i] || c < 0 || c >= C) return;
  float t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = tri[(size_t)i * 9 + j];
  unsigned* row = ctx + ((size_t)(i / BN) * C + c) * W;
  for (int w = 0; w < W; ++w) {
    unsigned bits = 0u;
    for (int kk = 0; kk < 32; ++kk) {
      const int k = w * 32 + kk;
      if (k >= K) break;
      if (!pmask[(size_t)c * K + k]) continue;
      const float* p = planes + ((size_t)c * K + k) * 4;
      bool beyond = false;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float d = ((t[j * 3] * p[0] + t[j * 3 + 1] * p[1]) + t[j * 3 + 2] * p[2]) + p[3];
        beyond |= d > tol;
      }
      if (beyond) bits |= 1u << kk;
    }
    if (bits) atomicOr(row + w, bits);
  }
}

__global__ void __launch_bounds__(THREADS)
soup_fold_kernel(const float* __restrict__ tri, const unsigned char* __restrict__ valid,
                 const int* __restrict__ cell, const float* __restrict__ planes,
                 const unsigned char* __restrict__ pmask, const unsigned* __restrict__ ctx,
                 float* __restrict__ poly_out, int* __restrict__ nv_out,
                 int* __restrict__ mrun_out, int P, int C, int K, int BN, int W, float tol) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  float px[S], py[S], pz[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s < 3) {
      px[s] = tri[(size_t)i * 9 + s * 3];
      py[s] = tri[(size_t)i * 9 + s * 3 + 1];
      pz[s] = tri[(size_t)i * 9 + s * 3 + 2];
    } else {
      px[s] = py[s] = pz[s] = 0.0f;
    }
  }
  int nv = valid[i] ? 3 : 0;
  int mrun = 0;
  const int c = cell[i];
  if (c >= 0 && c < C) {
    const unsigned* crow = ctx + ((size_t)(i / BN) * C + c) * W;
    for (int k = 0; k < K; ++k) {
      if (!pmask[(size_t)c * K + k]) continue;      // masked plane: no-op
      if (nv == 0) {
        // A live plane folds an empty polygon to all-zero slots, and every
        // later plane keeps them so: the same result without the work.
#pragma unroll
        for (int s = 0; s < S; ++s) px[s] = py[s] = pz[s] = 0.0f;
        break;
      }
      const float* p = planes + ((size_t)c * K + k) * 4;
      const float nx = p[0], ny = p[1], nz = p[2], d = p[3];
      const bool rm_any = (crow[k >> 5] >> (k & 31)) & 1u;

      float dist[S];
#pragma unroll
      for (int s = 0; s < S; ++s) dist[s] = ((px[s] * nx + py[s] * ny) + pz[s] * nz) + d;

      float exx = 0.0f, exy = 0.0f, exz = 0.0f, enx = 0.0f, eny = 0.0f, enz = 0.0f;
      int ex = 0, en = 0, mcnt = 0, nstarts = 0, a = 0;
      bool inplane = true;
      bool kprev = false;                            // kept[nv - 1], cyclic predecessor of slot 0
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s == nv - 1) kprev = dist[s] <= tol;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool m = s < nv;
        const bool last = s == nv - 1;
        const int n1 = (s + 1) % S;
        const float vx = last ? px[0] : px[n1];
        const float vy = last ? py[0] : py[n1];
        const float vz = last ? pz[0] : pz[n1];
        const float dn = last ? dist[0] : dist[n1];
        const float ds = dist[s];
        const float denom = dn - ds;
        const float safe = fabsf(denom) > 1e-30f ? denom : 1.0f;
        const float cx = (px[s] * dn - vx * ds) / safe;
        const float cy = (py[s] * dn - vy * ds) / safe;
        const float cz = (pz[s] * dn - vz * ds) / safe;
        const bool cex = m && ds < -tol && dn > tol;
        const bool cen = m && ds > tol && dn < -tol;
        const float fe = cex ? 1.0f : 0.0f;
        const float fn = cen ? 1.0f : 0.0f;
        exx = exx + fe * cx;
        exy = exy + fe * cy;
        exz = exz + fe * cz;
        enx = enx + fn * cx;
        eny = eny + fn * cy;
        enz = enz + fn * cz;
        ex |= cex;
        en |= cen;
        const bool kept = m && ds <= tol;
        if (kept && !kprev) {
          ++nstarts;
          a += s;
        }
        mcnt += kept;
        if (m && !(fabsf(ds) <= tol)) inplane = false;
        kprev = kept;
      }
      inplane = inplane && nv > 0;

      // Emit [rotated kept run, exit, enter]: rot[j] = poly[(a + j) mod nv].
      float ox[S], oy[S], oz[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        int src = a + j;
        if (src >= nv) src -= nv;
        float rx = 0.0f, ry = 0.0f, rz = 0.0f;
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (s == src) { rx = px[s]; ry = py[s]; rz = pz[s]; }
        if (j < mcnt) {
          ox[j] = rx; oy[j] = ry; oz[j] = rz;
        } else if (j == mcnt && ex) {
          ox[j] = exx; oy[j] = exy; oz[j] = exz;
        } else if (j == mcnt + ex && en) {
          ox[j] = enx; oy[j] = eny; oz[j] = enz;
        } else {
          ox[j] = 0.0f; oy[j] = 0.0f; oz[j] = 0.0f;
        }
      }
      int n_out = min(mcnt + ex + en, S);
      if (inplane && rm_any) n_out = 0;
      const bool multirun = nstarts > 1;
      if (multirun) n_out = 0;
      if (n_out < 3) n_out = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        px[s] = ox[s];
        py[s] = oy[s];
        pz[s] = oz[s];
      }
      nv = n_out;
      mrun += multirun;
    }
  }
  float* o = poly_out + (size_t)i * S * 3;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    o[s * 3] = px[s];
    o[s * 3 + 1] = py[s];
    o[s * 3 + 2] = pz[s];
  }
  nv_out[i] = nv;
  mrun_out[i] = mrun;
}

}  // namespace

// ctx: scratch of ceil(P / BN) * C * W words, zeroed here. Launches the
// context pass then the fold on `stream`; returns the first CUDA error.
extern "C" int surtr_soup_clip(const float* tri, const unsigned char* valid, const int* cell,
                               const float* planes, const unsigned char* pmask, unsigned* ctx,
                               float* poly, int* nv, int* mrun, int P, int C, int K, int BN,
                               int W, float tol, void* stream) {
  if (P <= 0) return 0;
  if (BN <= 0 || W < (K + 31) / 32 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t words = (size_t)((P + BN - 1) / BN) * (size_t)(C > 0 ? C : 1) * W;
  cudaError_t e = cudaMemsetAsync(ctx, 0, words * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const int grid = (P + THREADS - 1) / THREADS;
  soup_ctx_kernel<<<grid, THREADS, 0, st>>>(tri, valid, cell, planes, pmask, ctx, P, C, K, BN,
                                            W, tol);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  soup_fold_kernel<<<grid, THREADS, 0, st>>>(tri, valid, cell, planes, pmask, ctx, poly, nv,
                                             mrun, P, C, K, BN, W, tol);
  return (int)cudaGetLastError();
}
