// Greedy limited incremental convex hull of one point set (kernel B2).
//
// Replaces: surtr_tpu/ops/hull_pallas.py `_ich_kernel` (wrapper
// `ich_pallas`). Semantics of the plain `ich` in
// surtr_tpu_torch/ops/hull.py: seed tetrahedron from first-of-ties extreme
// points, then `limit - 4` greedy insertions of the point with the largest
// sum of positive face volumes; horizon by twin-edge matching; new faces on
// the free slots in slot order (the stable argsort of the JAX version, so
// face slots match slot for slot); outward orientation against the seed
// centroid; final unit normals, faces with |n| <= 1e-20 dropped.
//
// What bounds it on the card: latency. The work is tiny (F = 44 faces, a
// few thousand points at most) and strictly serial across insertions, so
// the cost is the chain of block barriers, not bytes or FLOPs. Design: one
// block for the whole hull; points are spread over the threads for the
// per-point priority passes and the first-of-ties argmax (block reduction
// on (value, index) pairs, lowest index wins ties, as jnp.argmax); the face
// table lives in shared memory and the O(F^2) horizon / slot assignment is
// done by one thread, which at F = 44 is shorter than a barrier round trip
// of a parallel version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -3.4e38f;
constexpr int THREADS = 256;
constexpr int MAXF = 128;

__device__ __forceinline__ void load3(const float* p, int i, float* o) {
  o[0] = p[i * 3]; o[1] = p[i * 3 + 1]; o[2] = p[i * 3 + 2];
}

// det(a-p, b-p, c-p) = (a-p) . ((b-p) x (c-p))
__device__ __forceinline__ float tet_vol(const float* a, const float* b,
                                         const float* c, const float* p) {
  const float ax = a[0] - p[0], ay = a[1] - p[1], az = a[2] - p[2];
  const float bx = b[0] - p[0], by = b[1] - p[1], bz = b[2] - p[2];
  const float cx = c[0] - p[0], cy = c[1] - p[1], cz = c[2] - p[2];
  const float x = by * cz - bz * cy;
  const float y = bz * cx - bx * cz;
  const float z = bx * cy - by * cx;
  return (ax * x + ay * y) + az * z;
}

// First-of-ties block argmax over per-thread candidates.
__device__ int block_argmax(float v, int i, float* sv, int* si) {
  const int t = threadIdx.x;
  sv[t] = v; si[t] = i;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) {
      const float ov = sv[t + s];
      const int oi = si[t + s];
      if (ov > sv[t] || (ov == sv[t] && oi < si[t])) { sv[t] = ov; si[t] = oi; }
    }
    __syncthreads();
  }
  const int r = si[0];
  __syncthreads();
  return r;
}

struct Acc {
  float v; int i;
  __device__ void add(float x, int j) {
    if (x > v || (x == v && j < i)) { v = x; i = j; }
  }
};

__global__ void ich_kernel(const float* __restrict__ pts,
                           const unsigned char* __restrict__ mask,
                           float* __restrict__ prio, int N, int F, int n_insert,
                           float* __restrict__ normals,
                           unsigned char* __restrict__ fvalid_out,
                           float* __restrict__ inner_out,
                           int* __restrict__ faces_out) {
  __shared__ float sv[THREADS];
  __shared__ int si[THREADS];
  __shared__ int faces[MAXF * 3], faces2[MAXF * 3];
  __shared__ int fvalid[MAXF], fvalid2[MAXF], visible[MAXF], isnew[MAXF];
  __shared__ float inner[3];
  __shared__ int any_vis_s;
  const int t = threadIdx.x;

  // --- seed tetrahedron ---
  Acc acc{-INFINITY, 0x7fffffff};
  for (int j = t; j < N; j += blockDim.x) acc.add(mask[j] ? pts[j * 3] : NEG, j);
  const int i1 = block_argmax(acc.v, acc.i, sv, si);
  float p1[3]; load3(pts, i1, p1);
  acc = Acc{-INFINITY, 0x7fffffff};
  for (int j = t; j < N; j += blockDim.x) {
    const float dx = pts[j * 3] - p1[0], dy = pts[j * 3 + 1] - p1[1], dz = pts[j * 3 + 2] - p1[2];
    acc.add(mask[j] ? (dx * dx + dy * dy) + dz * dz : NEG, j);
  }
  const int i2 = block_argmax(acc.v, acc.i, sv, si);
  float p2[3]; load3(pts, i2, p2);
  const float ex = p2[0] - p1[0], ey = p2[1] - p1[1], ez = p2[2] - p1[2];
  acc = Acc{-INFINITY, 0x7fffffff};
  for (int j = t; j < N; j += blockDim.x) {
    const float rx = pts[j * 3] - p1[0], ry = pts[j * 3 + 1] - p1[1], rz = pts[j * 3 + 2] - p1[2];
    const float cx = ey * rz - ez * ry, cy = ez * rx - ex * rz, cz = ex * ry - ey * rx;
    acc.add(mask[j] ? (cx * cx + cy * cy) + cz * cz : NEG, j);
  }
  const int i3 = block_argmax(acc.v, acc.i, sv, si);
  float p3[3]; load3(pts, i3, p3);
  acc = Acc{-INFINITY, 0x7fffffff};
  for (int j = t; j < N; j += blockDim.x) {
    float q[3]; load3(pts, j, q);
    acc.add(mask[j] ? tet_vol(p1, p2, p3, q) : NEG, j);
  }
  const int i4 = block_argmax(acc.v, acc.i, sv, si);
  float p4[3]; load3(pts, i4, p4);

  if (t == 0) {
    for (int a = 0; a < 3; ++a) inner[a] = (((p1[a] + p2[a]) + p3[a]) + p4[a]) * 0.25f;
    const int init[4][3] = {{i1, i2, i3}, {i1, i2, i4}, {i1, i3, i4}, {i2, i3, i4}};
    for (int g = 0; g < F; ++g) {
      fvalid[g] = g < 4;
      for (int c = 0; c < 3; ++c) faces[g * 3 + c] = g < 4 ? init[g][c] : 0;
    }
    for (int g = 0; g < 4; ++g) {
      float a[3], b[3], c[3];
      load3(pts, faces[g * 3], a); load3(pts, faces[g * 3 + 1], b); load3(pts, faces[g * 3 + 2], c);
      if (tet_vol(a, b, c, inner) < 0) {
        const int tmp = faces[g * 3 + 1]; faces[g * 3 + 1] = faces[g * 3 + 2]; faces[g * 3 + 2] = tmp;
      }
    }
  }
  __syncthreads();

  // Initial priorities: sum of positive volumes over the seed faces.
  for (int j = t; j < N; j += blockDim.x) {
    float q[3]; load3(pts, j, q);
    float s = 0.f;
    for (int g = 0; g < F; ++g) {
      float v = 0.f;
      if (fvalid[g]) {
        float a[3], b[3], c[3];
        load3(pts, faces[g * 3], a); load3(pts, faces[g * 3 + 1], b); load3(pts, faces[g * 3 + 2], c);
        v = tet_vol(a, b, c, q);
      }
      s += fmaxf(v, 0.f);
    }
    const bool seeded = j == i1 || j == i2 || j == i3 || j == i4;
    prio[j] = (mask[j] && !seeded) ? s : NEG;
  }
  __syncthreads();

  for (int it = 0; it < n_insert; ++it) {
    acc = Acc{-INFINITY, 0x7fffffff};
    for (int j = t; j < N; j += blockDim.x) acc.add(prio[j], j);
    const int k = block_argmax(acc.v, acc.i, sv, si);
    float pk[3]; load3(pts, k, pk);
    if (t == 0) {
      const bool can = prio[k] > NEG / 2;
      int any = 0;
      for (int g = 0; g < F; ++g) {
        visible[g] = 0;
        if (fvalid[g]) {
          float a[3], b[3], c[3];
          load3(pts, faces[g * 3], a); load3(pts, faces[g * 3 + 1], b); load3(pts, faces[g * 3 + 2], c);
          visible[g] = tet_vol(a, b, c, pk) < 0;
        }
        any |= visible[g];
      }
      const int any_vis = any && can;
      any_vis_s = any_vis;
      // Free slots (stable: invalid slots first in slot order, then valid).
      int order[MAXF];
      int no = 0;
      for (int g = 0; g < F; ++g) {
        fvalid2[g] = fvalid[g] && !(visible[g] && any_vis);
        for (int c = 0; c < 3; ++c) faces2[g * 3 + c] = faces[g * 3 + c];
      }
      for (int g = 0; g < F; ++g) if (!fvalid2[g]) order[no++] = g;
      for (int g = 0; g < F; ++g) if (fvalid2[g]) order[no++] = g;
      for (int g = 0; g < F; ++g) isnew[g] = 0;
      int rank = 0;
      for (int e = 0; e < 3 * F; ++e) {
        const int g = e / 3, c = e % 3;
        if (!(visible[g] && fvalid[g])) continue;
        const int e0 = faces[g * 3 + c], e1 = faces[g * 3 + (c + 1) % 3];
        bool hidden_twin = false;
        for (int h = 0; h < F && !hidden_twin; ++h) {
          if (!fvalid[h] || visible[h]) continue;
          for (int cc = 0; cc < 3; ++cc)
            if (faces[h * 3 + cc] == e1 && faces[h * 3 + (cc + 1) % 3] == e0) { hidden_twin = true; break; }
        }
        if (!hidden_twin) continue;
        const int slot = order[rank < F - 1 ? rank : F - 1];
        ++rank;
        if (!any_vis) continue;
        int nf[3] = {e0, e1, k};
        float a[3], b[3], cpt[3];
        load3(pts, nf[0], a); load3(pts, nf[1], b); load3(pts, nf[2], cpt);
        if (tet_vol(a, b, cpt, inner) < 0) { const int tmp = nf[1]; nf[1] = nf[2]; nf[2] = tmp; }
        for (int q = 0; q < 3; ++q) faces2[slot * 3 + q] = nf[q];
        fvalid2[slot] = 1;
      }
      for (int g = 0; g < F; ++g) {
        const bool mid = fvalid[g] && !(visible[g] && any_vis);
        isnew[g] = fvalid2[g] && !mid;
      }
    }
    __syncthreads();
    const int any_vis = any_vis_s;
    // Priority update: add the new faces' positive volumes, subtract the
    // removed visible faces'.
    for (int j = t; j < N; j += blockDim.x) {
      if (j == k) { prio[j] = NEG; continue; }
      if (!any_vis) continue;
      float q[3]; load3(pts, j, q);
      float sn = 0.f, so = 0.f;
      for (int g = 0; g < F; ++g) {
        float a[3], b[3], c[3];
        if (isnew[g]) {
          load3(pts, faces2[g * 3], a); load3(pts, faces2[g * 3 + 1], b); load3(pts, faces2[g * 3 + 2], c);
          sn += fmaxf(tet_vol(a, b, c, q), 0.f);
        }
        if (visible[g]) {
          load3(pts, faces[g * 3], a); load3(pts, faces[g * 3 + 1], b); load3(pts, faces[g * 3 + 2], c);
          so += fmaxf(tet_vol(a, b, c, q), 0.f);
        }
      }
      const float pr = prio[j];
      prio[j] = pr > NEG / 2 ? pr + (sn - so) : NEG;
    }
    __syncthreads();
    if (t == 0 && any_vis) {
      for (int g = 0; g < F; ++g) {
        fvalid[g] = fvalid2[g];
        for (int c = 0; c < 3; ++c) faces[g * 3 + c] = faces2[g * 3 + c];
      }
    }
    __syncthreads();
  }

  for (int g = t; g < F; g += blockDim.x) {
    float a[3], b[3], c[3];
    load3(pts, faces[g * 3], a); load3(pts, faces[g * 3 + 1], b); load3(pts, faces[g * 3 + 2], c);
    const float ux = b[0] - a[0], uy = b[1] - a[1], uz = b[2] - a[2];
    const float wx = c[0] - a[0], wy = c[1] - a[1], wz = c[2] - a[2];
    const float nx = uy * wz - uz * wy, ny = uz * wx - ux * wz, nz = ux * wy - uy * wx;
    const float ln = sqrtf((nx * nx + ny * ny) + nz * nz);
    const bool ok = fvalid[g] && ln > 1e-20f;
    const float den = fmaxf(ln, 1e-30f);
    normals[g * 3 + 0] = ok ? nx / den : 0.f;
    normals[g * 3 + 1] = ok ? ny / den : 0.f;
    normals[g * 3 + 2] = ok ? nz / den : 0.f;
    fvalid_out[g] = ok;
    for (int q = 0; q < 3; ++q) faces_out[g * 3 + q] = faces[g * 3 + q];
  }
  if (t < 3) inner_out[t] = inner[t];
}

}  // namespace

extern "C" int surtr_ich(const float* pts, const unsigned char* mask,
                         float* prio, int N, int F, int n_insert,
                         float* normals, unsigned char* fvalid, float* inner,
                         int* faces, void* stream) {
  if (F > MAXF || F < 4) return (int)cudaErrorInvalidValue;
  ich_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      pts, mask, prio, N, F, n_insert, normals, fvalid, inner, faces);
  return (int)cudaGetLastError();
}
