// Greedy limited incremental convex hull of one point set, or of a batch of
// independent point sets, one block a set (kernel B2).
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
// What bounds it on the card: latency. The work is tiny (F <= 128 face
// slots, 8 points on the cube, 162 on the sphere) and strictly serial
// across insertions, so the cost is the length of each insertion's chain
// of dependent steps, not bytes or FLOPs. Design: one block of 1 to 16
// warps (one warp a 64 points, so the cube and the sphere's 162 points take
// 1 and 3 warps). The points and their priorities are staged once in
// shared memory as (x, y, z, priority) (above 12,288 points they stay in a
// device-memory scratch of the same layout), and each thread keeps its
// points' running argmax while it updates their priorities, so an
// insertion has one pass over the points. Every argmax is a warp shuffle
// tree on a (value, index) key, lower index on ties (jnp.argmax), with one
// shared-memory round between warps. Warp 0 owns the face table (corner
// indices and corner coordinates per slot in shared memory, the valid set
// as bit words in registers) and does an insertion's face work on its 32
// lanes: visibility one face a lane (ballot); the stable free-slot order
// "invalid slots first" by popcounts; the horizon by one hidden face a
// lane, each flagging the visible faces' edges whose twin (the reversed
// edge) it holds; then one horizon edge a lane, its rank the horizon edges
// before it in (face, corner) order from a ballot and a popcount, its slot
// order[min(rank, F - 1)] (a saturated slot keeps the last edge's face, as
// the plain scatter does). The added and the removed
// faces' corners go to two lists in slot order, from which every point's
// priority update sums its terms in the plain version's order.
//
// The batched entry (`surtr_ich_batch`, the refit hull of every fracture
// candidate at refitting_point_limit > 4) launches the same kernel on a
// grid of B blocks: block b reads set b of a (B, N, 3) table and writes
// its slice of each output, with its points staged in N * 16 bytes of
// dynamic shared memory (a 608-point pool is 9.5 KiB, so several blocks
// share an SM) or, above 12,288 points, in its own slice of the scratch.
// Each block does exactly what the one-set launch does, with the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -3.4e38f;
constexpr int MAXF = 128;          // face slots (ich_general_kernel beyond)
constexpr int FW = MAXF / 32;      // 32-slot words of a face set
constexpr int MAXW = 16;           // warps a block at most
constexpr int STAGE_MAX = 12288;   // points staged in shared memory (192 KiB)
constexpr unsigned FULL = 0xffffffffu;

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

// (v, i) takes (x, j) when x is larger, or equal with a lower index.
__device__ __forceinline__ void take(float& v, int& i, float x, int j) {
  if (x > v || (x == v && j < i)) { v = x; i = j; }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    take(v, i, ov, oi);
  }
}

// First-of-ties argmax over the block; every thread gets the (value,
// index). `rv`/`ri` alternate between two buffers from call to call, so a
// warp that runs ahead never overwrites partials another warp still reads.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* rv, int* ri) {
  warp_argmax(v, i);
  const int W = blockDim.x >> 5;
  if (W == 1) {
    __syncwarp();
    return;
  }
  const int lane = threadIdx.x & 31;
  if (lane == 0) { rv[threadIdx.x >> 5] = v; ri[threadIdx.x >> 5] = i; }
  __syncthreads();
  v = lane < W ? rv[lane] : -INFINITY;
  i = lane < W ? ri[lane] : 0x7fffffff;
  warp_argmax(v, i);
}

__device__ __forceinline__ void copy9(float* dst, const float* src) {
#pragma unroll
  for (int q = 0; q < 9; ++q) dst[q] = src[q];
}

template <bool STAGED>
__global__ void __launch_bounds__(MAXW * 32)
ich_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ mask,
           float4* __restrict__ scratch, int N, int F, int n_insert,
           float* __restrict__ normals, unsigned char* __restrict__ fvalid_out,
           float* __restrict__ inner_out, int* __restrict__ faces_out) {
  extern __shared__ float4 staged_pts[];
  __shared__ int faces[MAXF * 3];
  __shared__ float fc[MAXF * 9];                 // each slot's corner coordinates
  __shared__ float dnew[MAXF * 9], dvis[MAXF * 9];  // added / removed faces, slot order
  __shared__ int st_f[MAXF * 3];                 // new faces by horizon rank
  __shared__ float st_c[MAXF * 9];
  __shared__ int order[MAXF], vis_list[MAXF], hz_flag[3 * MAXF];
  __shared__ float red_v[2][MAXW];
  __shared__ int red_i[2][MAXW];
  __shared__ int any_vis_s, n_new_s, n_vis_s;

  // Set blockIdx.x of a batch (the one-set launch is block 0).
  {
    const size_t b = blockIdx.x;
    pts += b * N * 3;
    mask += b * N;
    scratch += b * N;
    normals += b * F * 3;
    fvalid_out += b * F;
    inner_out += b * 3;
    faces_out += b * F * 3;
  }
  float4* P = STAGED ? staged_pts : scratch;     // (x, y, z, priority)
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, T = blockDim.x;
  const unsigned lt = (1u << lane) - 1u;
  int par = 0;
  auto argmax = [&](float& v, int& i) {
    block_argmax(v, i, red_v[par], red_i[par]);
    par ^= 1;
  };

  // --- seed tetrahedron; masked points carry priority NEG throughout ---
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int j = t; j < N; j += T) {
    const float x = pts[3 * j], y = pts[3 * j + 1], z = pts[3 * j + 2];
    const bool m = mask[j] != 0;
    P[j] = make_float4(x, y, z, m ? 0.f : NEG);
    take(bv, bi, m ? x : NEG, j);
  }
  argmax(bv, bi);
  const int i1 = bi;
  const float4 q1 = P[i1];
  const float p1[3] = {q1.x, q1.y, q1.z};
  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < N; j += T) {
    const float4 q = P[j];
    const float dx = q.x - p1[0], dy = q.y - p1[1], dz = q.z - p1[2];
    take(bv, bi, q.w > NEG / 2 ? (dx * dx + dy * dy) + dz * dz : NEG, j);
  }
  argmax(bv, bi);
  const int i2 = bi;
  const float4 q2 = P[i2];
  const float p2[3] = {q2.x, q2.y, q2.z};
  const float ex = p2[0] - p1[0], ey = p2[1] - p1[1], ez = p2[2] - p1[2];
  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < N; j += T) {
    const float4 q = P[j];
    const float rx = q.x - p1[0], ry = q.y - p1[1], rz = q.z - p1[2];
    const float cx = ey * rz - ez * ry, cy = ez * rx - ex * rz, cz = ex * ry - ey * rx;
    take(bv, bi, q.w > NEG / 2 ? (cx * cx + cy * cy) + cz * cz : NEG, j);
  }
  argmax(bv, bi);
  const int i3 = bi;
  const float4 q3 = P[i3];
  const float p3[3] = {q3.x, q3.y, q3.z};
  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < N; j += T) {
    const float4 q = P[j];
    const float qq[3] = {q.x, q.y, q.z};
    take(bv, bi, q.w > NEG / 2 ? tet_vol(p1, p2, p3, qq) : NEG, j);
  }
  argmax(bv, bi);
  const int i4 = bi;
  const float4 q4 = P[i4];
  float inner[3];
  {
    const float p4[3] = {q4.x, q4.y, q4.z};
#pragma unroll
    for (int a = 0; a < 3; ++a) inner[a] = (((p1[a] + p2[a]) + p3[a]) + p4[a]) * 0.25f;
  }

  // Warp 0 owns the face table; the valid set lives in its registers.
  unsigned fv[FW];
#pragma unroll
  for (int r = 0; r < FW; ++r) fv[r] = r == 0 ? 0xfu : 0u;
  if (warp == 0) {
    const int init[4][3] = {{i1, i2, i3}, {i1, i2, i4}, {i1, i3, i4}, {i2, i3, i4}};
    for (int g = lane; g < F; g += 32) {
      int f[3] = {0, 0, 0};
      float c[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (g < 4) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          f[q] = init[g][q];
          const float4 v = P[f[q]];
          c[3 * q] = v.x; c[3 * q + 1] = v.y; c[3 * q + 2] = v.z;
        }
        if (tet_vol(c, c + 3, c + 6, inner) < 0.f) {
          const int ti = f[1]; f[1] = f[2]; f[2] = ti;
#pragma unroll
          for (int q = 0; q < 3; ++q) { const float tc = c[3 + q]; c[3 + q] = c[6 + q]; c[6 + q] = tc; }
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) faces[3 * g + q] = f[q];
      copy9(fc + 9 * g, c);
    }
  }
  __syncthreads();

  // Initial priorities: the sum of positive volumes over the seed faces in
  // slot order (the other slots add +0), fused with the first argmax.
  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < N; j += T) {
    const float4 q = P[j];
    const float qq[3] = {q.x, q.y, q.z};
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) s += fmaxf(tet_vol(fc + 9 * g, fc + 9 * g + 3, fc + 9 * g + 6, qq), 0.f);
    const bool seeded = j == i1 || j == i2 || j == i3 || j == i4;
    const float w = (q.w > NEG / 2 && !seeded) ? s : NEG;
    P[j].w = w;
    take(bv, bi, w, j);
  }
  argmax(bv, bi);

  for (int it = 0; it < n_insert; ++it) {
    const int k = bi;
    if (warp == 0) {
      const bool can = bv > NEG / 2;
      const float4 k4 = P[k];
      const float pk[3] = {k4.x, k4.y, k4.z};
      unsigned vm[FW];
      unsigned any = 0u;
#pragma unroll
      for (int r = 0; r < FW; ++r) {
        const int g = lane + 32 * r;
        vm[r] = 0u;
        if (32 * r < F) {
          bool vis = false;
          if (g < F && ((fv[r] >> lane) & 1u))
            vis = tet_vol(fc + 9 * g, fc + 9 * g + 3, fc + 9 * g + 6, pk) < 0.f;
          vm[r] = __ballot_sync(FULL, vis);
        }
        any |= vm[r];
      }
      if (!(any != 0u && can)) {
        if (lane == 0) any_vis_s = 0;
      } else {
        // Slots that stay valid: the others, invalid first, take new faces
        // in rank order (the stable sort of "stays valid").
        unsigned mid[FW];
        int nmid = 0;
#pragma unroll
        for (int r = 0; r < FW; ++r) { mid[r] = fv[r] & ~vm[r]; nmid += __popc(mid[r]); }
        const int nfree = F - nmid;
        int pos[FW];
        int cm = 0, cf = 0, nvis = 0;
#pragma unroll
        for (int r = 0; r < FW; ++r) {
          const int g = lane + 32 * r;
          const int left = F - 32 * r;
          const unsigned fm = left >= 32 ? FULL : (left > 0 ? (1u << left) - 1u : 0u);
          const unsigned freew = fm & ~mid[r];
          pos[r] = 0x7fffffff;
          if (g < F) {
            pos[r] = ((mid[r] >> lane) & 1u) ? nfree + cm + __popc(mid[r] & lt)
                                             : cf + __popc(freew & lt);
            order[pos[r]] = g;
            if ((vm[r] >> lane) & 1u) {
              const int vp = nvis + __popc(vm[r] & lt);
              vis_list[vp] = g;
              copy9(dvis + 9 * vp, fc + 9 * g);
            }
          }
          cm += __popc(mid[r]);
          cf += __popc(freew);
          nvis += __popc(vm[r]);
        }
        __syncwarp();
        // Horizon: the edges of visible faces whose twin (the reversed edge)
        // is an edge of a hidden face. Each lane takes a hidden face and
        // flags the visible faces' edges it is the twin of.
        const int E = 3 * nvis;
        for (int e = lane; e < E; e += 32) hz_flag[e] = 0;
        __syncwarp();
#pragma unroll
        for (int r = 0; r < FW; ++r) {
          if (32 * r < F && ((mid[r] >> lane) & 1u)) {
            const int h = lane + 32 * r;
            const int h0 = faces[3 * h], h1 = faces[3 * h + 1], h2 = faces[3 * h + 2];
            for (int vp = 0; vp < nvis; ++vp) {
              const int g = vis_list[vp];
              const int g0 = faces[3 * g], g1 = faces[3 * g + 1], g2 = faces[3 * g + 2];
              const int ge[3][2] = {{g0, g1}, {g1, g2}, {g2, g0}};
#pragma unroll
              for (int c = 0; c < 3; ++c) {
                const int e0 = ge[c][0], e1 = ge[c][1];
                if ((h0 == e1 && h1 == e0) || (h1 == e1 && h2 == e0) || (h2 == e1 && h0 == e0))
                  hz_flag[3 * vp + c] = 1;
              }
            }
          }
        }
        __syncwarp();
        int H = 0;
#pragma unroll 1
        for (int e = lane; e - lane < E; e += 32)
          H += __popc(__ballot_sync(FULL, e < E && hz_flag[e] != 0));
        // New faces (e0, e1, k), oriented against the seed centroid, staged
        // by rank; past F - 1 only the last edge's face lands (on F - 1).
        // Rolled loops keep the kernel's code small: a lone warp runs it.
        int base = 0;
#pragma unroll 1
        for (int e = lane; e - lane < E; e += 32) {
          const bool hz = e < E && hz_flag[e] != 0;
          const unsigned hb = __ballot_sync(FULL, hz);
          const int rank = base + __popc(hb & lt);
          base += __popc(hb);
          if (hz && (rank < F - 1 || rank == H - 1)) {
            const int g = vis_list[e / 3], c = e % 3, c1 = (c + 1) % 3;
            int nf[3] = {faces[3 * g + c], faces[3 * g + c1], k};
            float cc[9];
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              cc[q] = fc[9 * g + 3 * c + q];
              cc[3 + q] = fc[9 * g + 3 * c1 + q];
              cc[6 + q] = pk[q];
            }
            if (tet_vol(cc, cc + 3, cc + 6, inner) < 0.f) {
              const int ti = nf[1]; nf[1] = nf[2]; nf[2] = ti;
#pragma unroll
              for (int q = 0; q < 3; ++q) { const float tc = cc[3 + q]; cc[3 + q] = cc[6 + q]; cc[6 + q] = tc; }
            }
            const int s = rank < F - 1 ? rank : F - 1;
#pragma unroll
            for (int q = 0; q < 3; ++q) st_f[3 * s + q] = nf[q];
            copy9(st_c + 9 * s, cc);
          }
        }
        __syncwarp();
        const int nw = H < F ? H : F;
        for (int s = lane; s < nw; s += 32) {
          const int g = order[s];
#pragma unroll
          for (int q = 0; q < 3; ++q) faces[3 * g + q] = st_f[3 * s + q];
          copy9(fc + 9 * g, st_c + 9 * s);
        }
        __syncwarp();
        int nnew = 0;
#pragma unroll
        for (int r = 0; r < FW; ++r) {
          if (32 * r >= F) break;
          const unsigned written = __ballot_sync(FULL, pos[r] < nw);
          const unsigned nb = written & ~mid[r];
          if ((nb >> lane) & 1u) copy9(dnew + 9 * (nnew + __popc(nb & lt)), fc + 9 * (lane + 32 * r));
          nnew += __popc(nb);
          fv[r] = mid[r] | written;
        }
        if (lane == 0) { any_vis_s = 1; n_new_s = nnew; n_vis_s = nvis; }
      }
    }
    __syncthreads();
    // Priority update fused with the next argmax: add the new faces'
    // positive volumes and subtract the removed visible faces', each sum
    // in slot order.
    const bool any_vis = any_vis_s != 0;
    const int nn = n_new_s, nv = n_vis_s;
    bv = -INFINITY; bi = 0x7fffffff;
    for (int j = t; j < N; j += T) {
      float w = P[j].w;
      if (j == k) {
        w = NEG;
        P[j].w = w;
      } else if (any_vis && w > NEG / 2) {
        const float4 q = P[j];
        const float qq[3] = {q.x, q.y, q.z};
        float sn = 0.f, so = 0.f;
        for (int g = 0; g < nn; ++g)
          sn += fmaxf(tet_vol(dnew + 9 * g, dnew + 9 * g + 3, dnew + 9 * g + 6, qq), 0.f);
        for (int g = 0; g < nv; ++g)
          so += fmaxf(tet_vol(dvis + 9 * g, dvis + 9 * g + 3, dvis + 9 * g + 6, qq), 0.f);
        w = w + (sn - so);
        P[j].w = w;
      }
      take(bv, bi, w, j);
    }
    argmax(bv, bi);
  }

  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < FW; ++r) {
      const int g = lane + 32 * r;
      if (g >= F) continue;
      const float* a = fc + 9 * g;
      const float ux = a[3] - a[0], uy = a[4] - a[1], uz = a[5] - a[2];
      const float wx = a[6] - a[0], wy = a[7] - a[1], wz = a[8] - a[2];
      const float nx = uy * wz - uz * wy, ny = uz * wx - ux * wz, nz = ux * wy - uy * wx;
      const float ln = sqrtf((nx * nx + ny * ny) + nz * nz);
      const bool ok = ((fv[r] >> lane) & 1u) && ln > 1e-20f;
      const float den = fmaxf(ln, 1e-30f);
      normals[g * 3 + 0] = ok ? nx / den : 0.f;
      normals[g * 3 + 1] = ok ? ny / den : 0.f;
      normals[g * 3 + 2] = ok ? nz / den : 0.f;
      fvalid_out[g] = ok;
#pragma unroll
      for (int q = 0; q < 3; ++q) faces_out[g * 3 + q] = faces[g * 3 + q];
    }
    if (lane < 3) inner_out[lane] = inner[lane];
  }
}

// Words of the general variant's face table a set (face_words): corners
// (3F), corner coordinates (9F), valid, visible, kept, position and order
// (5F), the added and removed faces' coordinates (18F), the staged new faces
// (3F + 9F) and the horizon flags (3F).
__host__ __device__ inline long long face_words(int F) { return 50LL * F; }

// The general variant, for F > MAXF face slots: the same hull, the points
// in a device scratch (x, y, z, priority) and the face table in the set's
// slice of a second scratch; thread 0 does an insertion's face work
// serially, in the order the warp's ballots give it above (slots in order,
// the horizon edges in (face, corner) order, the saturated slot taking the
// last edge's face), and every thread updates its points' priorities from
// the added and removed faces in slot order.
__global__ void __launch_bounds__(MAXW * 32)
ich_general_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ mask,
                   float4* __restrict__ scratch, int* __restrict__ table, int N, int F,
                   int n_insert, float* __restrict__ normals,
                   unsigned char* __restrict__ fvalid_out, float* __restrict__ inner_out,
                   int* __restrict__ faces_out) {
  __shared__ float red_v[2][MAXW];
  __shared__ int red_i[2][MAXW];
  __shared__ int any_vis_s, n_new_s, n_vis_s;
  {
    const size_t b = blockIdx.x;
    pts += b * N * 3;
    mask += b * N;
    scratch += b * N;
    table += b * face_words(F);
    normals += b * F * 3;
    fvalid_out += b * F;
    inner_out += b * 3;
    faces_out += b * F * 3;
  }
  int* faces = table;                                         // 3F
  float* fc = reinterpret_cast<float*>(faces + 3 * F);        // 9F
  int* fval = reinterpret_cast<int*>(fc + 9 * F);             // F
  int* vis = fval + F;                                        // F
  int* mid = vis + F;                                         // F
  int* pos = mid + F;                                         // F
  int* order = pos + F;                                       // F
  float* dnew = reinterpret_cast<float*>(order + F);          // 9F
  float* dvis = dnew + 9 * F;                                 // 9F
  int* st_f = reinterpret_cast<int*>(dvis + 9 * F);           // 3F
  float* st_c = reinterpret_cast<float*>(st_f + 3 * F);       // 9F
  int* hz = reinterpret_cast<int*>(st_c + 9 * F);             // 3F
  float4* P = scratch;
  const int t = threadIdx.x, T = blockDim.x;
  int par = 0;
  auto argmax = [&](float& v, int& i) {
    block_argmax(v, i, red_v[par], red_i[par]);
    par ^= 1;
  };

  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int j = t; j < N; j += T) {
    const float x = pts[3 * j], y = pts[3 * j + 1], z = pts[3 * j + 2];
    const bool m = mask[j] != 0;
    P[j] = make_float4(x, y, z, m ? 0.f : NEG);
    take(bv, bi, m ? x : NEG, j);
  }
  argmax(bv, bi);
  const int i1 = bi;
  const float4 q1 = P[i1];
  const float p1[3] = {q1.x, q1.y, q1.z};
  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < N; j += T) {
    const float4 q = P[j];
    const float dx = q.x - p1[0], dy = q.y - p1[1], dz = q.z - p1[2];
    take(bv, bi, q.w > NEG / 2 ? (dx * dx + dy * dy) + dz * dz : NEG, j);
  }
  argmax(bv, bi);
  const int i2 = bi;
  const float4 q2 = P[i2];
  const float p2[3] = {q2.x, q2.y, q2.z};
  const float ex = p2[0] - p1[0], ey = p2[1] - p1[1], ez = p2[2] - p1[2];
  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < N; j += T) {
    const float4 q = P[j];
    const float rx = q.x - p1[0], ry = q.y - p1[1], rz = q.z - p1[2];
    const float cx = ey * rz - ez * ry, cy = ez * rx - ex * rz, cz = ex * ry - ey * rx;
    take(bv, bi, q.w > NEG / 2 ? (cx * cx + cy * cy) + cz * cz : NEG, j);
  }
  argmax(bv, bi);
  const int i3 = bi;
  const float4 q3 = P[i3];
  const float p3[3] = {q3.x, q3.y, q3.z};
  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < N; j += T) {
    const float4 q = P[j];
    const float qq[3] = {q.x, q.y, q.z};
    take(bv, bi, q.w > NEG / 2 ? tet_vol(p1, p2, p3, qq) : NEG, j);
  }
  argmax(bv, bi);
  const int i4 = bi;
  const float4 q4 = P[i4];
  float inner[3];
  {
    const float p4[3] = {q4.x, q4.y, q4.z};
#pragma unroll
    for (int a = 0; a < 3; ++a) inner[a] = (((p1[a] + p2[a]) + p3[a]) + p4[a]) * 0.25f;
  }
  const int init[4][3] = {{i1, i2, i3}, {i1, i2, i4}, {i1, i3, i4}, {i2, i3, i4}};
  for (int g = t; g < F; g += T) {
    int f[3] = {0, 0, 0};
    float c[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (g < 4) {
      for (int q = 0; q < 3; ++q) {
        f[q] = init[g][q];
        const float4 v = P[f[q]];
        c[3 * q] = v.x; c[3 * q + 1] = v.y; c[3 * q + 2] = v.z;
      }
      if (tet_vol(c, c + 3, c + 6, inner) < 0.f) {
        const int ti = f[1]; f[1] = f[2]; f[2] = ti;
        for (int q = 0; q < 3; ++q) { const float tc = c[3 + q]; c[3 + q] = c[6 + q]; c[6 + q] = tc; }
      }
    }
    for (int q = 0; q < 3; ++q) faces[3 * g + q] = f[q];
    copy9(fc + 9 * g, c);
    fval[g] = g < 4;
  }
  __syncthreads();

  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < N; j += T) {
    const float4 q = P[j];
    const float qq[3] = {q.x, q.y, q.z};
    float s = 0.f;
    for (int g = 0; g < 4; ++g) s += fmaxf(tet_vol(fc + 9 * g, fc + 9 * g + 3, fc + 9 * g + 6, qq), 0.f);
    const bool seeded = j == i1 || j == i2 || j == i3 || j == i4;
    const float w = (q.w > NEG / 2 && !seeded) ? s : NEG;
    P[j].w = w;
    take(bv, bi, w, j);
  }
  argmax(bv, bi);

  for (int it = 0; it < n_insert; ++it) {
    const int k = bi;
    if (t == 0) {
      const bool can = bv > NEG / 2;
      const float4 k4 = P[k];
      const float pk[3] = {k4.x, k4.y, k4.z};
      int nvis = 0, nmid = 0;
      for (int g = 0; g < F; ++g) {
        vis[g] = fval[g] && tet_vol(fc + 9 * g, fc + 9 * g + 3, fc + 9 * g + 6, pk) < 0.f;
        mid[g] = fval[g] && !vis[g];
        nvis += vis[g];
        nmid += mid[g];
      }
      if (nvis == 0 || !can) {
        any_vis_s = 0;
      } else {
        // Free slots (invalid first, in slot order), then the kept ones.
        // `vis` becomes the list of visible faces in slot order (entry vp
        // <= g is written after vis[g] is read).
        int cf = 0, cm = 0, vp = 0;
        for (int g = 0; g < F; ++g) {
          pos[g] = mid[g] ? (F - nmid) + cm++ : cf++;
          order[pos[g]] = g;
          if (vis[g]) {
            copy9(dvis + 9 * vp, fc + 9 * g);
            vis[vp++] = g;
          }
        }
        // Horizon edges (visible face, corner) in order: a hidden face
        // holds the reversed edge. Their faces (e0, e1, k) by rank.
        int H = 0;
        for (int e = 0; e < 3 * nvis; ++e) {
          const int g = vis[e / 3], c = e % 3, c1 = (c + 1) % 3;
          const int e0 = faces[3 * g + c], e1 = faces[3 * g + c1];
          bool flag = false;
          for (int h = 0; h < F && !flag; ++h) {
            if (!mid[h]) continue;
            const int h0 = faces[3 * h], h1 = faces[3 * h + 1], h2 = faces[3 * h + 2];
            flag = (h0 == e1 && h1 == e0) || (h1 == e1 && h2 == e0) || (h2 == e1 && h0 == e0);
          }
          H += flag;
          hz[e] = flag;
        }
        int rank = 0;
        for (int e = 0; e < 3 * nvis; ++e) {
          if (!hz[e]) continue;
          if (rank < F - 1 || rank == H - 1) {
            const int g = vis[e / 3], c = e % 3, c1 = (c + 1) % 3;
            int nf[3] = {faces[3 * g + c], faces[3 * g + c1], k};
            float cc[9];
            for (int q = 0; q < 3; ++q) {
              cc[q] = fc[9 * g + 3 * c + q];
              cc[3 + q] = fc[9 * g + 3 * c1 + q];
              cc[6 + q] = pk[q];
            }
            if (tet_vol(cc, cc + 3, cc + 6, inner) < 0.f) {
              const int ti = nf[1]; nf[1] = nf[2]; nf[2] = ti;
              for (int q = 0; q < 3; ++q) { const float tc = cc[3 + q]; cc[3 + q] = cc[6 + q]; cc[6 + q] = tc; }
            }
            const int sl = rank < F - 1 ? rank : F - 1;
            for (int q = 0; q < 3; ++q) st_f[3 * sl + q] = nf[q];
            copy9(st_c + 9 * sl, cc);
          }
          ++rank;
        }
        const int nw = H < F ? H : F;
        for (int sl = 0; sl < nw; ++sl) {
          const int g = order[sl];
          for (int q = 0; q < 3; ++q) faces[3 * g + q] = st_f[3 * sl + q];
          copy9(fc + 9 * g, st_c + 9 * sl);
        }
        int nnew = 0;
        for (int g = 0; g < F; ++g) {
          const bool written = pos[g] < nw;
          if (written && !mid[g]) copy9(dnew + 9 * nnew++, fc + 9 * g);
          fval[g] = mid[g] || written;
        }
        any_vis_s = 1; n_new_s = nnew; n_vis_s = nvis;
      }
    }
    __syncthreads();
    const bool any_vis = any_vis_s != 0;
    const int nn = n_new_s, nv = n_vis_s;
    bv = -INFINITY; bi = 0x7fffffff;
    for (int j = t; j < N; j += T) {
      float w = P[j].w;
      if (j == k) {
        w = NEG;
        P[j].w = w;
      } else if (any_vis && w > NEG / 2) {
        const float4 q = P[j];
        const float qq[3] = {q.x, q.y, q.z};
        float sn = 0.f, so = 0.f;
        for (int g = 0; g < nn; ++g)
          sn += fmaxf(tet_vol(dnew + 9 * g, dnew + 9 * g + 3, dnew + 9 * g + 6, qq), 0.f);
        for (int g = 0; g < nv; ++g)
          so += fmaxf(tet_vol(dvis + 9 * g, dvis + 9 * g + 3, dvis + 9 * g + 6, qq), 0.f);
        w = w + (sn - so);
        P[j].w = w;
      }
      take(bv, bi, w, j);
    }
    argmax(bv, bi);
  }

  for (int g = t; g < F; g += T) {
    const float* a = fc + 9 * g;
    const float ux = a[3] - a[0], uy = a[4] - a[1], uz = a[5] - a[2];
    const float wx = a[6] - a[0], wy = a[7] - a[1], wz = a[8] - a[2];
    const float nx = uy * wz - uz * wy, ny = uz * wx - ux * wz, nz = ux * wy - uy * wx;
    const float ln = sqrtf((nx * nx + ny * ny) + nz * nz);
    const bool ok = fval[g] && ln > 1e-20f;
    const float den = fmaxf(ln, 1e-30f);
    normals[g * 3 + 0] = ok ? nx / den : 0.f;
    normals[g * 3 + 1] = ok ? ny / den : 0.f;
    normals[g * 3 + 2] = ok ? nz / den : 0.f;
    fvalid_out[g] = ok;
    for (int q = 0; q < 3; ++q) faces_out[g * 3 + q] = faces[g * 3 + q];
  }
  if (t < 3) inner_out[t] = inner[t];
}

// Threads for N points: a warp a 64 points, 1 to MAXW warps.
int ich_threads(int N) {
  const int w = (N + 63) / 64;
  return 32 * (w < 1 ? 1 : (w > MAXW ? MAXW : w));
}

}  // namespace

// The staged kernel's shared-memory limit, set once a device (a function
// attribute belongs to the current device).
static int set_smem_attr() {
  constexpr int MAX_DEVICES = 64;
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(ich_kernel<true>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               STAGE_MAX * (int)sizeof(float4));
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  return 0;
}

// B sets of N points each, one block a set: pts (B, N, 3), mask (B, N),
// outputs (B, F, 3), (B, F), (B, 3), (B, F, 3); scratch (B, N, 4) float32,
// used when N > STAGE_MAX or F > MAXF. F > MAXF takes the general variant,
// with `table` holding B · face_words(F) ints.
extern "C" int surtr_ich_batch(const float* pts, const unsigned char* mask, void* scratch,
                               int* table, int B, int N, int F, int n_insert, float* normals,
                               unsigned char* fvalid, float* inner, int* faces, void* stream) {
  if (F < 4 || N < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (F > MAXF) {
    if (table == nullptr) return (int)cudaErrorInvalidValue;
    ich_general_kernel<<<B, ich_threads(N), 0, s>>>(pts, mask, (float4*)scratch, table, N, F,
                                                    n_insert, normals, fvalid, inner, faces);
    return (int)cudaGetLastError();
  }
  const int rc = set_smem_attr();
  if (rc != 0) return rc;
  if (N <= STAGE_MAX)
    ich_kernel<true><<<B, ich_threads(N), (size_t)N * sizeof(float4), s>>>(
        pts, mask, (float4*)scratch, N, F, n_insert, normals, fvalid, inner, faces);
  else
    ich_kernel<false><<<B, ich_threads(N), 0, s>>>(
        pts, mask, (float4*)scratch, N, F, n_insert, normals, fvalid, inner, faces);
  return (int)cudaGetLastError();
}

// One set (the model hull): the batch of one.
extern "C" int surtr_ich(const float* pts, const unsigned char* mask, void* scratch, int* table,
                         int N, int F, int n_insert, float* normals, unsigned char* fvalid,
                         float* inner, int* faces, void* stream) {
  return surtr_ich_batch(pts, mask, scratch, table, 1, N, F, n_insert, normals, fvalid, inner,
                         faces, stream);
}
