// Greedy limited incremental convex hull of one point set, or of a batch of
// independent point sets (kernel B2).
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
// candidate at refitting_point_limit > 4) takes one of three variants, which
// the wrapper picks from (B, N, F) alone and all of which give the same bits:
//
// * ich_kernel (above) on a grid of B blocks, block b on set b, its points
//   in N * 16 bytes of dynamic shared memory (above 12,288 points in its own
//   slice of the scratch): the one-set hull (B = 1, F <= 128), and batches
//   whose sets are too large for a warp.
//
// * ich_warp_set_kernel, for B > 1 sets of at most WARP_SET_BYTES each (the
//   refit pools: 1,088 sets of 512-608 slots, 77-90 live points a set, F =
//   20 or 44). What bounds it: latency, as for the one-set hull, but over
//   many short sets, so the design keeps every set resident at once and
//   takes the barriers out of each insertion's chain. One warp does one set
//   (SETS_PER_BLOCK sets a block), so every argmax is a shuffle tree and the
//   insertion loop has no __syncthreads, only __syncwarp. The warp stages
//   only the set's live points and its first masked slot, in slot order
//   (ich_set says why every pick stays the same), so a lane's share of a
//   pass is 2-3 live points rather than 19 slots of which most are masked:
//   the lanes no longer wait on the one lane that found a live point in a
//   round (that cut the cube's limit-20 pool 0.167 -> 0.072 ms on an H100).
//   The priority pass takes PB of a lane's points at a time, loading each
//   face's corners once for all of them. A face's corners are read from the
//   staged points by index, so the face table holds corner indices only,
//   sized to F rounded up to 32 slots (not to MAXF); points, their slots
//   and table take 17.6 KB at 608 slots and F = 44, so the 1,088 sets of a
//   limit-20 pool are all resident in one wave.
//
// * ich_general_kernel, for F > MAXF (refitting_point_limit or
//   ich_include_point_limit > 62): a block a set, its threads scanning the
//   points as ich_kernel's do (a warp a 64 points), warp 0 doing the face
//   work of ich_warp_set_kernel over a runtime count of 32-slot words
//   (ich_kernel's ballots and popcounts, each word's sets in the table)
//   while the other warps wait at one barrier an insertion. What bounds it:
//   the same serial chain, now F / 32 words long, and the point scans of a
//   large set (6,560 slots at limit 64). The points and the face table stay
//   in dynamic shared memory while they fit (general_stage), else in the
//   set's slices of device scratches.
//
// All three keep ich_kernel's order of every argmax, sum and write, so they
// agree bit for bit with each other and with the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -3.4e38f;
constexpr int MAXF = 128;          // face slots of ich_kernel and ich_warp_set_kernel
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

// ---------------------------------------------------------------------------
// The warp-a-set variant and the general variant share one face table
// layout and one warp's face work (face_step).

constexpr int SETS_PER_BLOCK = 2;           // warps (sets) a block of the warp-a-set variant
constexpr int WARP_SET_BYTES = 48 * 1024;   // a set's points, their slots and face table, at most
constexpr int GENERAL_SMEM = 200 * 1024;    // the general variant's dynamic shared memory, at most

// A set's face table for Fp = 32 * nw slots (nw = ceil(F / 32) words of 32
// slots), in 32-bit words: four int4 arrays of Fp (each slot's corner
// indices; the added faces' and the removed faces' corners, each in slot
// order; the new faces by horizon rank), then each slot's place in the
// free-slot order, that order and the horizon flags (5 Fp ints), then the
// valid, visible and kept slot sets as bit words (3 nw, rounded up to 4
// words so that a set's slice stays 16-byte aligned).
__host__ __device__ inline long long table_words(int F) {
  const long long nw = (F + 31) / 32;
  return 21 * 32 * nw + (3 * nw + 3) / 4 * 4;
}

// Words of the warp-a-set variant's map from staged entries to slots, up
// to N of them, rounded up to 4.
__host__ __device__ inline long long orig_words(int N) { return (N + 3LL) / 4 * 4; }

// Bytes of one set of the warp-a-set variant: up to N staged points (x, y,
// z, priority), their slots and its face table.
__host__ __device__ inline long long set_bytes(int N, int F) {
  return 16LL * N + 4 * orig_words(N) + 4 * table_words(F);
}

// What the general variant keeps in dynamic shared memory: bit 0 the points,
// bit 1 the face table (both while they fit, else the table alone while it
// fits); the rest stays in the set's slice of a device scratch.
inline int general_stage(int N, int F) {
  const long long tb = 4 * table_words(F);
  if (tb + 16LL * N <= GENERAL_SMEM) return 3;
  return tb <= GENERAL_SMEM ? 2 : 0;
}

inline long long general_smem(int N, int F) {
  const int st = general_stage(N, F);
  return ((st & 1) ? 16LL * N : 0) + ((st & 2) ? 4 * table_words(F) : 0);
}

struct FaceTable {
  int4 *faces, *dnew, *dvis, *st_f;
  int *pos, *order, *hz;
  unsigned *fv, *vm, *mid;
};

__device__ __forceinline__ FaceTable face_table(int* base, int F) {
  const int nw = (F + 31) / 32, Fp = 32 * nw;
  int4* q = reinterpret_cast<int4*>(base);
  int* s = base + 16 * Fp;
  unsigned* w = reinterpret_cast<unsigned*>(s + 5 * Fp);
  return {q, q + Fp, q + 2 * Fp, q + 3 * Fp, s, s + Fp, s + 2 * Fp, w, w + nw, w + 2 * nw};
}

__device__ __forceinline__ void xyz(const float4* P, int i, float* a) {
  const float4 v = P[i];
  a[0] = v.x; a[1] = v.y; a[2] = v.z;
}

// vol(face f, p): a face's corners are its points' coordinates.
__device__ __forceinline__ float face_vol(const float4* P, int4 f, const float* p) {
  float a[3], b[3], c[3];
  xyz(P, f.x, a); xyz(P, f.y, b); xyz(P, f.z, c);
  return tet_vol(a, b, c, p);
}

// One insertion's face work on the 32 lanes of one warp, for point k (can:
// its priority is live): ich_kernel's warp 0 steps over nw words of 32
// slots, the word sets in the table so that nw may be a runtime count (NW =
// 0) or a template one. Visibility one slot a lane (ballot); the free-slot
// order by popcounts; the horizon by one kept face a lane flagging the
// removed faces' edges it holds the twin of; one horizon edge a lane, its
// rank by ballot, its face staged at order[min(rank, F - 1)]; the added and
// removed faces' corners listed in slot order. Returns whether the hull
// changed (every lane the same), with the added and removed counts.
template <int NW>
__device__ bool face_step(const FaceTable& tb, const float4* P, int F, int k, bool can,
                          const float* inner, int& nn, int& nv) {
  const int nw = NW > 0 ? NW : (F + 31) / 32;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  float pk[3];
  xyz(P, k, pk);
  unsigned any = 0u;
#pragma unroll
  for (int r = 0; r < nw; ++r) {
    const int g = lane + 32 * r;
    const bool vis = g < F && ((tb.fv[r] >> lane) & 1u) && face_vol(P, tb.faces[g], pk) < 0.f;
    const unsigned m = __ballot_sync(FULL, vis);
    if (lane == 0) tb.vm[r] = m;
    any |= m;
  }
  if (!(any != 0u && can)) return false;
  __syncwarp();
  int nmid = 0;
#pragma unroll
  for (int r = 0; r < nw; ++r) {
    const unsigned m = tb.fv[r] & ~tb.vm[r];
    if (lane == 0) tb.mid[r] = m;
    nmid += __popc(m);
  }
  __syncwarp();
  // Slots that stay valid: the others, invalid first, take new faces in
  // rank order (the stable sort of "stays valid").
  const int nfree = F - nmid;
  int cm = 0, cf = 0, nvis = 0;
#pragma unroll
  for (int r = 0; r < nw; ++r) {
    const int g = lane + 32 * r;
    const int left = F - 32 * r;
    const unsigned fm = left >= 32 ? FULL : (1u << left) - 1u;
    const unsigned mid = tb.mid[r], vm = tb.vm[r];
    const unsigned freew = fm & ~mid;
    if (g < F) {
      const int p = ((mid >> lane) & 1u) ? nfree + cm + __popc(mid & lt)
                                         : cf + __popc(freew & lt);
      tb.order[p] = g;
      tb.pos[g] = p;
      if ((vm >> lane) & 1u) tb.dvis[nvis + __popc(vm & lt)] = tb.faces[g];
    }
    cm += __popc(mid);
    cf += __popc(freew);
    nvis += __popc(vm);
  }
  __syncwarp();
  // Horizon: the removed faces' edges whose twin (the reversed edge) is an
  // edge of a kept face.
  const int E = 3 * nvis;
  for (int e = lane; e < E; e += 32) tb.hz[e] = 0;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < nw; ++r) {
    const int h = lane + 32 * r;
    if (h < F && ((tb.mid[r] >> lane) & 1u)) {
      const int4 hf = tb.faces[h];
      for (int vp = 0; vp < nvis; ++vp) {
        const int4 gf = tb.dvis[vp];
        const int ge[3][2] = {{gf.x, gf.y}, {gf.y, gf.z}, {gf.z, gf.x}};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int e0 = ge[c][0], e1 = ge[c][1];
          if ((hf.x == e1 && hf.y == e0) || (hf.y == e1 && hf.z == e0) ||
              (hf.z == e1 && hf.x == e0))
            tb.hz[3 * vp + c] = 1;
        }
      }
    }
  }
  __syncwarp();
  int H = 0;
#pragma unroll 1
  for (int e = lane; e - lane < E; e += 32)
    H += __popc(__ballot_sync(FULL, e < E && tb.hz[e] != 0));
  // New faces (e0, e1, k), oriented against the seed centroid, staged by
  // rank; past F - 1 only the last edge's face lands (on F - 1).
  int base = 0;
#pragma unroll 1
  for (int e = lane; e - lane < E; e += 32) {
    const bool hz = e < E && tb.hz[e] != 0;
    const unsigned hb = __ballot_sync(FULL, hz);
    const int rank = base + __popc(hb & lt);
    base += __popc(hb);
    if (hz && (rank < F - 1 || rank == H - 1)) {
      const int4 gf = tb.dvis[e / 3];
      const int c = e % 3;
      const int e0 = c == 0 ? gf.x : (c == 1 ? gf.y : gf.z);
      const int e1 = c == 0 ? gf.y : (c == 1 ? gf.z : gf.x);
      float a[3], b[3];
      xyz(P, e0, a);
      xyz(P, e1, b);
      const bool flip = tet_vol(a, b, pk, inner) < 0.f;
      tb.st_f[rank < F - 1 ? rank : F - 1] = flip ? make_int4(e0, k, e1, 0)
                                                  : make_int4(e0, e1, k, 0);
    }
  }
  __syncwarp();
  const int nwr = H < F ? H : F;
  for (int s = lane; s < nwr; s += 32) tb.faces[tb.order[s]] = tb.st_f[s];
  __syncwarp();
  int nnew = 0;
#pragma unroll
  for (int r = 0; r < nw; ++r) {
    const int g = lane + 32 * r;
    const unsigned written = __ballot_sync(FULL, g < F && tb.pos[g] < nwr);
    const unsigned mid = tb.mid[r];
    const unsigned nb = written & ~mid;
    if ((nb >> lane) & 1u) tb.dnew[nnew + __popc(nb & lt)] = tb.faces[g];
    nnew += __popc(nb);
    if (lane == 0) tb.fv[r] = mid | written;
  }
  __syncwarp();
  nn = nnew;
  nv = nvis;
  return true;
}

// Points a lane updates at once in the warp-a-set variant's priority pass:
// each face's corners are loaded once for all of them, and their volumes
// are independent chains.
constexpr int PB = 4;

// The hull of one set by a group of threads: one warp (WARP_SET; t the
// lane, T = 32, argmaxes by shuffles, no block barrier) or one block
// (t the thread, T its size, argmaxes across warps, warp 0 doing the face
// work while the others wait at a barrier). P holds the set's points (x,
// y, z, priority) and tab its face table; the steps, their order and their
// arithmetic are ich_kernel's.
//
// The warp stages only the live points and the first masked one (`orig`
// maps its n staged entries back to slots): every argmax gives a masked
// slot NEG, so over all N slots it picks what it picks over these n, and a
// lane's share of each pass is live points, not masked slots. Indices in
// the face table are then staged entries; slots never written hold -1 and
// leave as 0, as the plain table's do.
template <int NW, bool WARP_SET>
__device__ void ich_set(const float* __restrict__ pts, const unsigned char* __restrict__ mask,
                        float4* P, int* orig, int* tab, int N, int F, int n_insert,
                        float* __restrict__ normals, unsigned char* __restrict__ fvalid_out,
                        float* __restrict__ inner_out, int* __restrict__ faces_out,
                        float (*red_v)[MAXW], int (*red_i)[MAXW], int* step_s) {
  const int t = WARP_SET ? (threadIdx.x & 31) : threadIdx.x;
  const int T = WARP_SET ? 32 : blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const FaceTable tb = face_table(tab, F);
  int par = 0;
  auto argmax = [&](float& v, int& i) {
    if constexpr (WARP_SET) {
      warp_argmax(v, i);
      __syncwarp();
    } else {
      block_argmax(v, i, red_v[par], red_i[par]);
      par ^= 1;
    }
  };

  // --- seed tetrahedron; masked points carry priority NEG throughout ---
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  int n = N;   // staged entries
  if constexpr (WARP_SET) {
    const unsigned lt = (1u << lane) - 1u;
    n = 0;
    bool first_masked = true;
    for (int j0 = 0; j0 < N; j0 += 32) {
      const int j = j0 + lane;
      const bool live = j < N && mask[j] != 0;
      unsigned keep = __ballot_sync(FULL, live);
      if (first_masked) {
        const unsigned dead = __ballot_sync(FULL, j < N && !live);
        keep |= dead & (0u - dead);
        first_masked = dead == 0u;
      }
      if ((keep >> lane) & 1u) {
        const int c = n + __popc(keep & lt);
        const float x = pts[3 * j], y = pts[3 * j + 1], z = pts[3 * j + 2];
        P[c] = make_float4(x, y, z, live ? 0.f : NEG);
        orig[c] = j;
        take(bv, bi, live ? x : NEG, c);
      }
      n += __popc(keep);
    }
  } else {
    for (int j = t; j < N; j += T) {
      const float x = pts[3 * j], y = pts[3 * j + 1], z = pts[3 * j + 2];
      const bool m = mask[j] != 0;
      P[j] = make_float4(x, y, z, m ? 0.f : NEG);
      take(bv, bi, m ? x : NEG, j);
    }
  }
  argmax(bv, bi);
  const int i1 = bi;
  float p1[3];
  xyz(P, i1, p1);
  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < n; j += T) {
    const float4 q = P[j];
    const float dx = q.x - p1[0], dy = q.y - p1[1], dz = q.z - p1[2];
    take(bv, bi, q.w > NEG / 2 ? (dx * dx + dy * dy) + dz * dz : NEG, j);
  }
  argmax(bv, bi);
  const int i2 = bi;
  float p2[3];
  xyz(P, i2, p2);
  const float ex = p2[0] - p1[0], ey = p2[1] - p1[1], ez = p2[2] - p1[2];
  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < n; j += T) {
    const float4 q = P[j];
    const float rx = q.x - p1[0], ry = q.y - p1[1], rz = q.z - p1[2];
    const float cx = ey * rz - ez * ry, cy = ez * rx - ex * rz, cz = ex * ry - ey * rx;
    take(bv, bi, q.w > NEG / 2 ? (cx * cx + cy * cy) + cz * cz : NEG, j);
  }
  argmax(bv, bi);
  const int i3 = bi;
  float p3[3];
  xyz(P, i3, p3);
  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < n; j += T) {
    const float4 q = P[j];
    const float qq[3] = {q.x, q.y, q.z};
    take(bv, bi, q.w > NEG / 2 ? tet_vol(p1, p2, p3, qq) : NEG, j);
  }
  argmax(bv, bi);
  const int i4 = bi;
  float inner[3];
  {
    float p4[3];
    xyz(P, i4, p4);
#pragma unroll
    for (int a = 0; a < 3; ++a) inner[a] = (((p1[a] + p2[a]) + p3[a]) + p4[a]) * 0.25f;
  }
  // The seed faces on slots 0-3, oriented outward; the other slots invalid
  // and never written (-1).
  for (int g = t; g < F; g += T) {
    int4 f = make_int4(-1, -1, -1, 0);
    if (g < 4) {
      f = g == 0 ? make_int4(i1, i2, i3, 0) : g == 1 ? make_int4(i1, i2, i4, 0)
        : g == 2 ? make_int4(i1, i3, i4, 0) : make_int4(i2, i3, i4, 0);
      if (face_vol(P, f, inner) < 0.f) f = make_int4(f.x, f.z, f.y, 0);
    }
    tb.faces[g] = f;
  }
  for (int r = t; r < (F + 31) / 32; r += T) tb.fv[r] = r == 0 ? 0xfu : 0u;
  if constexpr (WARP_SET) __syncwarp(); else __syncthreads();

  // Initial priorities: the sum of positive volumes over the seed faces in
  // slot order, fused with the first argmax.
  float sc[4][9];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int4 f = tb.faces[g];
    xyz(P, f.x, sc[g]); xyz(P, f.y, sc[g] + 3); xyz(P, f.z, sc[g] + 6);
  }
  bv = -INFINITY; bi = 0x7fffffff;
  for (int j = t; j < n; j += T) {
    const float4 q = P[j];
    const float qq[3] = {q.x, q.y, q.z};
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) s += fmaxf(tet_vol(sc[g], sc[g] + 3, sc[g] + 6, qq), 0.f);
    const bool seeded = j == i1 || j == i2 || j == i3 || j == i4;
    const float w = (q.w > NEG / 2 && !seeded) ? s : NEG;
    P[j].w = w;
    take(bv, bi, w, j);
  }
  argmax(bv, bi);

  for (int it = 0; it < n_insert; ++it) {
    const int k = bi;
    const bool can = bv > NEG / 2;
    bool any;
    int nn = 0, nv = 0;
    if constexpr (WARP_SET) {
      any = face_step<NW>(tb, P, F, k, can, inner, nn, nv);
    } else {
      if (warp == 0) {
        const bool a = face_step<NW>(tb, P, F, k, can, inner, nn, nv);
        if (lane == 0) { step_s[0] = a; step_s[1] = nn; step_s[2] = nv; }
      }
      __syncthreads();
      any = step_s[0] != 0;
      nn = step_s[1];
      nv = step_s[2];
    }
    // Priority update fused with the next argmax: add the new faces'
    // positive volumes and subtract the removed faces', each sum in slot
    // order.
    bv = -INFINITY; bi = 0x7fffffff;
    if constexpr (WARP_SET) {
      // PB of the lane's points at a time, each face's corners loaded once.
      for (int j0 = t; j0 < n; j0 += 32 * PB) {
        float4 q[PB];
        float sn[PB], so[PB];
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          q[p] = j0 + 32 * p < n ? P[j0 + 32 * p] : make_float4(0.f, 0.f, 0.f, NEG);
          sn[p] = 0.f;
          so[p] = 0.f;
        }
        if (any) {
          for (int g = 0; g < nn; ++g) {
            const int4 f = tb.dnew[g];
            float a[3], b[3], c[3];
            xyz(P, f.x, a); xyz(P, f.y, b); xyz(P, f.z, c);
#pragma unroll
            for (int p = 0; p < PB; ++p) {
              const float qq[3] = {q[p].x, q[p].y, q[p].z};
              sn[p] += fmaxf(tet_vol(a, b, c, qq), 0.f);
            }
          }
          for (int g = 0; g < nv; ++g) {
            const int4 f = tb.dvis[g];
            float a[3], b[3], c[3];
            xyz(P, f.x, a); xyz(P, f.y, b); xyz(P, f.z, c);
#pragma unroll
            for (int p = 0; p < PB; ++p) {
              const float qq[3] = {q[p].x, q[p].y, q[p].z};
              so[p] += fmaxf(tet_vol(a, b, c, qq), 0.f);
            }
          }
        }
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          const int j = j0 + 32 * p;
          if (j >= n) break;
          float w = q[p].w;
          if (j == k) {
            w = NEG;
            P[j].w = w;
          } else if (any && w > NEG / 2) {
            w = w + (sn[p] - so[p]);
            P[j].w = w;
          }
          take(bv, bi, w, j);
        }
      }
    } else {
      for (int j = t; j < n; j += T) {
        float w = P[j].w;
        if (j == k) {
          w = NEG;
          P[j].w = w;
        } else if (any && w > NEG / 2) {
          const float4 q = P[j];
          const float qq[3] = {q.x, q.y, q.z};
          float sn = 0.f, so = 0.f;
          for (int g = 0; g < nn; ++g) sn += fmaxf(face_vol(P, tb.dnew[g], qq), 0.f);
          for (int g = 0; g < nv; ++g) so += fmaxf(face_vol(P, tb.dvis[g], qq), 0.f);
          w = w + (sn - so);
          P[j].w = w;
        }
        take(bv, bi, w, j);
      }
    }
    argmax(bv, bi);
  }

  // Unit normals of the valid faces (a valid face's corners are points of
  // the set); the corner indices back to slots.
  for (int g = t; g < F; g += T) {
    const int4 f = tb.faces[g];
    const bool valid = (tb.fv[g >> 5] >> (g & 31)) & 1u;
    float nx = 0.f, ny = 0.f, nz = 0.f, ln = 0.f;
    if (valid) {
      float a[9];
      xyz(P, f.x, a); xyz(P, f.y, a + 3); xyz(P, f.z, a + 6);
      const float ux = a[3] - a[0], uy = a[4] - a[1], uz = a[5] - a[2];
      const float wx = a[6] - a[0], wy = a[7] - a[1], wz = a[8] - a[2];
      nx = uy * wz - uz * wy;
      ny = uz * wx - ux * wz;
      nz = ux * wy - uy * wx;
      ln = sqrtf((nx * nx + ny * ny) + nz * nz);
    }
    const bool ok = valid && ln > 1e-20f;
    const float den = fmaxf(ln, 1e-30f);
    normals[g * 3 + 0] = ok ? nx / den : 0.f;
    normals[g * 3 + 1] = ok ? ny / den : 0.f;
    normals[g * 3 + 2] = ok ? nz / den : 0.f;
    fvalid_out[g] = ok;
    const int fi[3] = {f.x, f.y, f.z};
#pragma unroll
    for (int q = 0; q < 3; ++q)
      faces_out[g * 3 + q] = fi[q] < 0 ? 0 : (WARP_SET ? orig[fi[q]] : fi[q]);
  }
  if (t < 3) inner_out[t] = inner[t];
}

// The warp-a-set variant: SETS_PER_BLOCK warps a block, warp w taking set
// blockIdx.x * SETS_PER_BLOCK + w, its points and face table in its own
// set_bytes(N, F) slice of dynamic shared memory; NW = ceil(F / 32).
template <int NW>
__global__ void __launch_bounds__(32 * SETS_PER_BLOCK)
ich_warp_set_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ mask,
                    int B, int N, int F, int n_insert, float* __restrict__ normals,
                    unsigned char* __restrict__ fvalid_out, float* __restrict__ inner_out,
                    int* __restrict__ faces_out) {
  extern __shared__ float4 set_smem[];
  const int w = threadIdx.x >> 5;
  const size_t b = (size_t)blockIdx.x * SETS_PER_BLOCK + w;
  if (b >= (size_t)B) return;
  char* base = reinterpret_cast<char*>(set_smem) + w * set_bytes(N, F);
  ich_set<NW, true>(pts + b * N * 3, mask + b * N, reinterpret_cast<float4*>(base),
                    reinterpret_cast<int*>(base + 16LL * N),
                    reinterpret_cast<int*>(base + 16LL * N + 4 * orig_words(N)), N, F, n_insert,
                    normals + b * F * 3, fvalid_out + b * F, inner_out + b * 3,
                    faces_out + b * F * 3, nullptr, nullptr, nullptr);
}

// The general variant (F > MAXF): a block a set, its threads scanning the
// points (a warp a 64), warp 0 doing the face work on ceil(F / 32) words;
// the points and the face table in dynamic shared memory as general_stage
// says, else in the set's slices of `scratch` and `table`.
__global__ void __launch_bounds__(MAXW * 32)
ich_general_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ mask,
                   float4* __restrict__ scratch, int* __restrict__ table, int N, int F,
                   int n_insert, int stage, float* __restrict__ normals,
                   unsigned char* __restrict__ fvalid_out, float* __restrict__ inner_out,
                   int* __restrict__ faces_out) {
  extern __shared__ float4 gen_smem[];
  __shared__ float red_v[2][MAXW];
  __shared__ int red_i[2][MAXW];
  __shared__ int step_s[3];
  const size_t b = blockIdx.x;
  float4* P = (stage & 1) ? gen_smem : scratch + b * N;
  int* tab = (stage & 2) ? reinterpret_cast<int*>(gen_smem + ((stage & 1) ? N : 0))
                         : table + b * table_words(F);
  ich_set<0, false>(pts + b * N * 3, mask + b * N, P, nullptr, tab, N, F, n_insert,
                    normals + b * F * 3,
                    fvalid_out + b * F, inner_out + b * 3, faces_out + b * F * 3, red_v, red_i,
                    step_s);
}

// Threads for N points: a warp a 64 points, 1 to MAXW warps.
int ich_threads(int N) {
  const int w = (N + 63) / 64;
  return 32 * (w < 1 ? 1 : (w > MAXW ? MAXW : w));
}

template <int NW>
cudaError_t launch_warp_set(const float* pts, const unsigned char* mask, int B, int N, int F,
                            int n_insert, float* normals, unsigned char* fvalid, float* inner,
                            int* faces, cudaStream_t s) {
  const int blocks = (B + SETS_PER_BLOCK - 1) / SETS_PER_BLOCK;
  ich_warp_set_kernel<NW><<<blocks, 32 * SETS_PER_BLOCK,
                            (size_t)SETS_PER_BLOCK * set_bytes(N, F), s>>>(
      pts, mask, B, N, F, n_insert, normals, fvalid, inner, faces);
  return cudaGetLastError();
}

}  // namespace

// The kernels' shared-memory limits, set once a device (a function
// attribute belongs to the current device).
static int set_smem_attr() {
  constexpr int MAX_DEVICES = 64;
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    const auto a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    const int ws = SETS_PER_BLOCK * WARP_SET_BYTES;
    cudaError_t e = cudaFuncSetAttribute(ich_kernel<true>, a, STAGE_MAX * (int)sizeof(float4));
    if (e == cudaSuccess) e = cudaFuncSetAttribute(ich_warp_set_kernel<1>, a, ws);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(ich_warp_set_kernel<2>, a, ws);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(ich_warp_set_kernel<3>, a, ws);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(ich_warp_set_kernel<4>, a, ws);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(ich_general_kernel, a, GENERAL_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  return 0;
}

// The layouts the wrapper sizes its choice and its scratch by.
extern "C" long long surtr_ich_set_bytes(int N, int F) { return set_bytes(N, F); }
extern "C" long long surtr_ich_table_words(int F) { return table_words(F); }
extern "C" long long surtr_ich_general_stage(int N, int F) { return general_stage(N, F); }

// B sets of N points each: pts (B, N, 3), mask (B, N), outputs (B, F, 3),
// (B, F), (B, 3), (B, F, 3). `variant` (the wrapper's choice, a function of
// B, N and F): 0 ich_kernel, a block a set (scratch (B, N, 4) float32 when
// N > STAGE_MAX); 1 the warp-a-set variant (F <= MAXF, set_bytes(N, F) <=
// WARP_SET_BYTES); 2 the general variant (scratch (B, N, 4) float32 unless
// general_stage stages the points, `table` B * table_words(F) ints unless
// it stages the face table).
extern "C" int surtr_ich_batch(const float* pts, const unsigned char* mask, void* scratch,
                               int* table, int B, int N, int F, int n_insert, int variant,
                               float* normals, unsigned char* fvalid, float* inner, int* faces,
                               void* stream) {
  if (F < 4 || N < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = set_smem_attr();
  if (rc != 0) return rc;
  if (variant == 2) {
    const int st = general_stage(N, F);
    if ((!(st & 1) && scratch == nullptr) || (!(st & 2) && table == nullptr))
      return (int)cudaErrorInvalidValue;
    ich_general_kernel<<<B, ich_threads(N), (size_t)general_smem(N, F), s>>>(
        pts, mask, (float4*)scratch, table, N, F, n_insert, st, normals, fvalid, inner, faces);
    return (int)cudaGetLastError();
  }
  if (F > MAXF) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (set_bytes(N, F) > WARP_SET_BYTES) return (int)cudaErrorInvalidValue;
    switch ((F + 31) / 32) {
      case 1: return (int)launch_warp_set<1>(pts, mask, B, N, F, n_insert, normals, fvalid, inner, faces, s);
      case 2: return (int)launch_warp_set<2>(pts, mask, B, N, F, n_insert, normals, fvalid, inner, faces, s);
      case 3: return (int)launch_warp_set<3>(pts, mask, B, N, F, n_insert, normals, fvalid, inner, faces, s);
      default: return (int)launch_warp_set<4>(pts, mask, B, N, F, n_insert, normals, fvalid, inner, faces, s);
    }
  }
  if (variant != 0 || (N > STAGE_MAX && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  if (N <= STAGE_MAX)
    ich_kernel<true><<<B, ich_threads(N), (size_t)N * sizeof(float4), s>>>(
        pts, mask, (float4*)scratch, N, F, n_insert, normals, fvalid, inner, faces);
  else
    ich_kernel<false><<<B, ich_threads(N), 0, s>>>(
        pts, mask, (float4*)scratch, N, F, n_insert, normals, fvalid, inner, faces);
  return (int)cudaGetLastError();
}

// One set (the model hull): the batch of one, on ich_kernel up to MAXF face
// slots and on the general variant beyond.
extern "C" int surtr_ich(const float* pts, const unsigned char* mask, void* scratch, int* table,
                         int N, int F, int n_insert, float* normals, unsigned char* fvalid,
                         float* inner, int* faces, void* stream) {
  return surtr_ich_batch(pts, mask, scratch, table, 1, N, F, n_insert, F > MAXF ? 2 : 0,
                         normals, fvalid, inner, faces, stream);
}
