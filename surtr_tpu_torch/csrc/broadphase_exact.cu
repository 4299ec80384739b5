// Full-recall sweep-and-prune broadphase (kernel B6) and its glue.
//
// Replaces: surtr_tpu/physics/broadphase_pallas.py `_bp_exact_kernel`
// (wrapper `broadphase_exact_pallas`). Semantics of the plain version in
// surtr_tpu_torch/physics/broadphase_cuda.py `broadphase_exact_reference`:
// for each valid piece i, the K smallest keys (q(d²) << id_bits) | j over
// every valid j of another owner (j != i) whose margin AABB overlaps i's,
// with d² = ((dx·dx) + dy·dy) + dz·dz of centers normalized to the valid
// extent (d = j's center minus i's) and q = (int)min(d²·qs, qmax); θᵢ is the
// K-th key, IMAX when fewer than K. Keys are unique (the id field), so the
// K smallest do not depend on the order candidates are met in, and K-best
// lists built over any split of the candidates merge exactly.
//
// Three launches and one torch.sort (`broadphase_cuda._exact_kernel`):
//  1. bp_key_kernel (one CTA): the valid extent (bp_extent.cuh, shared
//     with B12's key launch), the sweep axis (largest extent, first of
//     ties) and the sort key where(valid, c[axis], BIG);
//  2. torch.sort(key, stable=True) in PyTorch;
//  3. bp_pack_kernel (one CTA per 128-row chunk): the sorted (Np_pad, 12)
//     table [normalized center 3 | owner | lo 3 | valid | hi 3 | id], each
//     32-row tile's AABB union over valid rows and each chunk's sweep-axis
//     interval;
//  4. bp_exact_kernel (one CTA per 32-piece query tile): the sweep.
// The plain mirror of 1-3 and of the sweep's schedule is `exact_glue` and
// `tile_schedule`. No step syncs with the host.
//
// What bounds the function on the card: its bytes, 117 B a piece in and
// out (1.2 MB at the 10k lattice, 0.35 µs at 3.35 TB/s); the keys need work
// only for the overlapping pairs. The sweep does more: about 20 operations
// per candidate test, and a sweep along one axis of a settled lattice meets
// whole cross-sections (chip_smoke.py prints the tests and the pairs).
// The first design (one 128-thread CTA per 128-piece block, 79 CTAs at 10k,
// a serial chunk walk with synchronous staging, ~40 PyTorch ops of glue)
// took 1.16-1.60 ms a call on an NVIDIA H100 80GB HBM3 at 700 W, 0.67-0.90
// ms of it glue. This design:
//  - glue: two launches instead of ~40 ops; the per-block chunk range of
//    the sorted order (prefix-max / suffix-min envelopes of the chunks'
//    sweep-axis intervals, as the JAX wrapper builds them) is computed by
//    each CTA as a min / max reduction over the chunk intervals;
//  - spread: 4 warps per 32-piece tile (316 CTAs, 1,264 warps at 10k); the
//    CTA culls the 32-row tiles of its range by AABB unions into a shared
//    list, warp g walks entries g, g+4, ...; the four K-best lists of a
//    piece merge in shared memory at the end;
//  - finer cull: tile unions against the query tile's union, then a ballot
//    of the rows whose own AABB meets it: only those rows are tested;
//  - staging: each warp double-buffers its row tiles (32 × 48 B) with
//    cp.async, so the next tile loads while the current one is tested.
// Each thread keeps its piece's K best keys sorted in registers (K ≤ 16,
// indexed by unrolled constants only; 32 or 64 in the long variant) and
// inserts only a key below its K-th. The results are written in original
// piece order: pidx = key & id_mask, pok = key != IMAX, key_ji = (key &
// ~id_mask) | i and θ.
// Measured at the 10k lattice's 64th step on an NVIDIA H100 80GB HBM3 at
// 700 W (tools/time_b1_b6.py, the first design in the same call): 0.34-0.36
// ms a call against 2.24-2.73 ms; the sweep 0.064 ms and the glue 0.054 ms
// on the device against 0.31 and 0.17 ms; 17 device launches against 74
// (14 of them the sort); 7.43 M candidate tests against 15.06 M.
// Past K = 16 the first design (bp_exact_general_kernel) ran a thread a
// piece over every row of the chunks its interval meets, its list in
// device memory (K loads and stores an insertion), in 8 CTAs at Np 1,000.
// The long variant (bp_exact_kernel<32>, <64>; 16 < K <= 64) is the sweep
// above with longer lists: 32 or 64 keys in registers (130 and 167 of
// them, no spill), the merge buffer 12 or 24 KB (32.8 and 45.1 KB of
// static shared memory). Its insertion takes the K-th key as the largest
// of the first K: picked at s == K - 1, the list went into a stack frame
// (0.104 ms at the 10k step against 0.069). What bounds it is the tiled
// sweep's: the cull's candidate tests, about 20 operations each, and one
// compare-exchange a list slot for each key inserted. Past K = 64 a list
// would take more registers than a thread has and the merge buffer alone
// 48 KB, so the general variant stays there. Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (tools/time_b1_b6.py --b6-only, device ms, the
// general variant in the same call): K = 32 at the 10k lattice's 64th step
// 0.069-0.070 against 0.602; on chip_smoke phase 30's 1,000-cube lattice
// 0.0174-0.0175 against 0.109-0.110.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bp_extent.cuh"

namespace {

constexpr int TILE = 32;        // pieces per query tile and rows per row tile
constexpr int CHUNK = 128;      // rows per sweep chunk (4 tiles)
constexpr int GROUPS = 4;       // warps per query tile
constexpr int ROW = 12;         // floats per table row
constexpr int MAX_TILES = 2048; // 65,536 pieces
constexpr int MAXK = 16;        // the tiled sweep's lists; the long variant's up to LONG_K
constexpr int LONG_K = 64;
constexpr int IMAX = 0x7FFFFFFF;
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

using surtr_bp::warp_max;
using surtr_bp::warp_min;

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ inline void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ inline void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// ---------------------------------------------------------------------------
// 1. The sweep key: one CTA reduces the valid extent and writes the keys.
// params = [wlo x, y, z, ext]; axis as an int.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(1024)
bp_key_kernel(const float* __restrict__ c, int cs, const unsigned char* __restrict__ valid,
              int Np, float* __restrict__ key, float* __restrict__ params,
              int* __restrict__ axis_out) {
  __shared__ int sax;
  const int t = threadIdx.x;
  float mn[3], mx[3];
  const bool any = surtr_bp::valid_extent(c, cs, valid, Np, mn, mx);
  if (t == 0) {
    float ext3[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) ext3[a] = mx[a] - mn[a];
    int ax = 0;                                   // argmax, first of ties
    if (ext3[1] > ext3[ax]) ax = 1;
    if (ext3[2] > ext3[ax]) ax = 2;
    float e = fmaxf(fmaxf(ext3[0], ext3[1]), ext3[2]);
    e = e < 1e-6f ? 1e-6f : e;                    // clamp(min=1e-6)
    if (!any) ax = 0;
    params[0] = mn[0];
    params[1] = mn[1];
    params[2] = mn[2];
    params[3] = e;
    *axis_out = ax;
    sax = ax;
  }
  __syncthreads();
  const int ax = sax;
  for (int i = t; i < Np; i += blockDim.x)
    key[i] = valid[i] ? c[(size_t)i * cs + ax] : BIG;
}

// ---------------------------------------------------------------------------
// 3. The sorted table, tile unions and chunk intervals: one CTA per chunk.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CHUNK)
bp_pack_kernel(const float* __restrict__ c, int cs, const float* __restrict__ lo, int ls,
               const float* __restrict__ hi, int hs, const int* __restrict__ owner,
               const unsigned char* __restrict__ valid, const int64_t* __restrict__ order,
               const float* __restrict__ params, const int* __restrict__ axis_in, int Np,
               float* __restrict__ table, float* __restrict__ tiles, float* __restrict__ chunks) {
  __shared__ float red[CHUNK / TILE][2];
  const int t = threadIdx.x;
  const int r = blockIdx.x * CHUNK + t;
  float row[ROW];
#pragma unroll
  for (int j = 0; j < ROW; ++j) row[j] = 0.0f;
  bool v = false;
  if (r < Np) {
    const int64_t p = order[r];
    v = valid[p] != 0;
    const float ext = params[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      row[a] = (c[p * cs + a] - params[a]) / ext;
      row[4 + a] = lo[p * ls + a];
      row[8 + a] = hi[p * hs + a];
    }
    row[3] = (float)owner[p];
    row[7] = v ? 1.0f : 0.0f;
    row[11] = (float)p;
  }
  float4* dst = reinterpret_cast<float4*>(table + (size_t)r * ROW);
  dst[0] = make_float4(row[0], row[1], row[2], row[3]);
  dst[1] = make_float4(row[4], row[5], row[6], row[7]);
  dst[2] = make_float4(row[8], row[9], row[10], row[11]);

  float u[6];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    u[a] = warp_min(v ? row[4 + a] : BIG);
    u[3 + a] = warp_max(v ? row[8 + a] : -BIG);
  }
  const int ax = *axis_in;
  if ((t & 31) == 0) {
    float4* tu = reinterpret_cast<float4*>(tiles + (size_t)(r / TILE) * 8);
    tu[0] = make_float4(u[0], u[1], u[2], 0.0f);
    tu[1] = make_float4(u[3], u[4], u[5], 0.0f);
    red[t >> 5][0] = ax == 0 ? u[0] : (ax == 1 ? u[1] : u[2]);
    red[t >> 5][1] = ax == 0 ? u[3] : (ax == 1 ? u[4] : u[5]);
  }
  __syncthreads();
  if (t == 0) {
    float a = red[0][0], b = red[0][1];
#pragma unroll
    for (int w = 1; w < CHUNK / TILE; ++w) {
      a = fminf(a, red[w][0]);
      b = fmaxf(b, red[w][1]);
    }
    chunks[2 * blockIdx.x] = a;
    chunks[2 * blockIdx.x + 1] = b;
  }
}

// ---------------------------------------------------------------------------
// 4. The sweep: one CTA of GROUPS warps per 32-piece query tile.
// ---------------------------------------------------------------------------
__device__ inline bool meets(float4 alo, float4 ahi, float4 blo, float4 bhi) {
  return alo.x <= bhi.x && blo.x <= ahi.x && alo.y <= bhi.y && blo.y <= ahi.y &&
         alo.z <= bhi.z && blo.z <= ahi.z;
}

__device__ inline void stage_tile(float* buf, const float* table, int u, int lane) {
  const float4* src = reinterpret_cast<const float4*>(table + (size_t)u * TILE * ROW);
  float4* dst = reinterpret_cast<float4*>(buf);
#pragma unroll
  for (int q = 0; q < TILE * ROW / 4 / 32; ++q)
    cp_async16(dst + lane + 32 * q, src + lane + 32 * q);
}

__device__ inline void insert(int (&best)[MAXK], int& kth, int v, int K) {
  if (v >= kth) return;
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

// The long variant's insertion: the same compare-exchange steps, always
// inlined, and the K-th key taken as the largest of the first K (the list
// is ascending) rather than picked at s == K - 1, which the compiler may
// turn into best[K - 1]: a run-time index that moves the list into a stack
// frame, so that every step loads and stores it (the K <= 16 sweep's
// `insert` keeps 64 bytes of it).
template <int NK>
__device__ __forceinline__ void insert_long(int (&best)[NK], int& kth, int v, int K) {
  if (v >= kth) return;
  int top = 0;                                     // keys are >= 0
#pragma unroll
  for (int s = 0; s < NK; ++s) {
    if (s < K) {
      const int lo = min(best[s], v);
      v = max(best[s], v);
      best[s] = lo;
      top = max(top, lo);
    }
  }
  kth = top;
}

// NK, the length of each thread's list: MAXK for K <= 16 (the tiled sweep),
// 32 or LONG_K for the long variant (16 < K <= 64). Only the lists and the
// merge buffer grow with it.
template <int NK>
__global__ void __launch_bounds__(GROUPS * 32)
bp_exact_kernel(const float* __restrict__ table, const float* __restrict__ tiles,
                const float* __restrict__ chunks, int Np, int NT, int NCH, int K, int id_bits,
                float qs, float qmax, int* __restrict__ pidx, unsigned char* __restrict__ pok,
                int* __restrict__ key_ji, int* __restrict__ theta) {
  __shared__ __align__(16) float stage[GROUPS][2][TILE * ROW];
  __shared__ int list[MAX_TILES];
  __shared__ int mrg[GROUPS - 1][NK][32];
  __shared__ int nlist, s_lo, s_hi;
  const int tq = blockIdx.x, tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    nlist = 0;
    s_lo = NCH;
    s_hi = 0;
  }
  const float4* tq4 = reinterpret_cast<const float4*>(tiles + (size_t)tq * 8);
  const float4 qlo = tq4[0], qhi = tq4[1];
  const int rank = tq * TILE + lane;               // < Np_pad: the table is padded
  const float4* me = reinterpret_cast<const float4*>(table + (size_t)rank * ROW);
  const float4 m0 = me[0], m1 = me[1], m2 = me[2];
  const float cx = m0.x, cy = m0.y, cz = m0.z, own = m0.w;
  const float lx = m1.x, ly = m1.y, lz = m1.z;
  const bool val = m1.w > 0.5f;
  const float hx = m2.x, hy = m2.y, hz = m2.z, orig = m2.w;
  __syncthreads();

  // The chunk range of this tile's chunk: every chunk whose sweep-axis
  // interval can meet it (the JAX wrapper's envelope ranges, as min / max).
  const int b = tq * TILE / CHUNK;
  const float clo = chunks[2 * b], chi = chunks[2 * b + 1];
  int lo_c = NCH, hi_c = 0;
  for (int ch = tid; ch < NCH; ch += GROUPS * 32) {
    if (chunks[2 * ch + 1] >= clo) lo_c = min(lo_c, ch);
    if (chunks[2 * ch] <= chi) hi_c = max(hi_c, ch + 1);
  }
  lo_c = __reduce_min_sync(FULL, lo_c);
  hi_c = __reduce_max_sync(FULL, hi_c);
  if (lane == 0) {
    atomicMin(&s_lo, lo_c);
    atomicMax(&s_hi, hi_c);
  }
  __syncthreads();

  // Cull the row tiles of the range by their unions into the shared list.
  const int u0 = s_lo * (CHUNK / TILE), u1 = min(s_hi * (CHUNK / TILE), NT);
  for (int base = u0; base < u1; base += GROUPS * 32) {
    const int u = base + tid;
    bool ok = false;
    if (u < u1) {
      const float4* tu = reinterpret_cast<const float4*>(tiles + (size_t)u * 8);
      ok = meets(tu[0], tu[1], qlo, qhi);
    }
    const unsigned m = __ballot_sync(FULL, ok);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&nlist, __popc(m));
    at = __shfl_sync(FULL, at, 0);
    if (ok) list[at + __popc(m & ((1u << lane) - 1))] = u;
  }
  __syncthreads();
  const int n = nlist;

  const int mask = (1 << id_bits) - 1;
  int best[NK];
#pragma unroll
  for (int s = 0; s < NK; ++s) best[s] = IMAX;
  int kth = IMAX;

  // Warp w walks list entries w, w + GROUPS, ...; double-buffered staging.
  const int mine = n > w ? (n - w + GROUPS - 1) / GROUPS : 0;
  if (mine > 0) stage_tile(stage[w][0], table, list[w], lane);
  cp_commit();
  for (int k = 0; k < mine; ++k) {
    if (k + 1 < mine) stage_tile(stage[w][(k + 1) & 1], table, list[w + GROUPS * (k + 1)], lane);
    cp_commit();
    cp_wait_one();
    __syncwarp();
    const float* rows = stage[w][k & 1];
    const float4* rl = reinterpret_cast<const float4*>(rows + lane * ROW);
    const float4 rlo = rl[1], rhi = rl[2];
    unsigned m = __ballot_sync(FULL, rlo.w > 0.5f && meets(rlo, rhi, qlo, qhi));
    while (m) {
      const int r = __ffs(m) - 1;
      m &= m - 1;
      if (!val) continue;
      const float4* o = reinterpret_cast<const float4*>(rows + r * ROW);
      const float4 o0 = o[0], o1 = o[1], o2 = o[2];
      const bool over = o1.x <= hx && lx <= o2.x && o1.y <= hy && ly <= o2.y && o1.z <= hz &&
                        lz <= o2.z;
      if (!over || o0.w == own || o2.w == orig) continue;
      const float dx = o0.x - cx, dy = o0.y - cy, dz = o0.z - cz;
      float d2 = dx * dx;
      d2 = d2 + dy * dy;
      d2 = d2 + dz * dz;
      const int q = (int)fminf(d2 * qs, qmax);
      const int key = (q << id_bits) | ((int)o2.w & mask);
      if constexpr (NK == MAXK)
        insert(best, kth, key, K);
      else
        insert_long(best, kth, key, K);
    }
    __syncwarp();                                  // the buffer is read before restaging
  }

  // Merge the groups' K-best lists (unique keys: exact in any order).
  if (w > 0) {
#pragma unroll
    for (int s = 0; s < NK; ++s)
      if (s < K) mrg[w - 1][s][lane] = best[s];
  }
  __syncthreads();
  if (w != 0) return;
  for (int g = 0; g < GROUPS - 1; ++g)
    for (int s = 0; s < K; ++s) {
      if constexpr (NK == MAXK)
        insert(best, kth, mrg[g][s][lane], K);
      else
        insert_long(best, kth, mrg[g][s][lane], K);
    }
  if (rank >= Np) return;
  const int i = (int)orig;
#pragma unroll
  for (int s = 0; s < NK; ++s) {
    if (s < K) {
      const int key = best[s];
      pidx[(size_t)i * K + s] = key & mask;
      pok[(size_t)i * K + s] = key != IMAX;
      key_ji[(size_t)i * K + s] = (key & ~mask) | i;
    }
  }
  theta[i] = kth;
}

// ---------------------------------------------------------------------------
// 4'. The general variant, for K > LONG_K: one thread a sorted piece, its K
// best keys kept sorted in a device scratch (slot s of rank r at
// best[s * Np_pad + r]), every 128-row chunk whose sweep-axis interval
// meets the piece's own walked row by row. The keys and the insertion are
// those of the sweep above (unique keys: the same K smallest).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128)
bp_exact_general_kernel(const float* __restrict__ table, const float* __restrict__ chunks,
                        const int* __restrict__ axis_in, int Np, int NCH, int K, int id_bits,
                        float qs, float qmax, int* __restrict__ best, int* __restrict__ pidx,
                        unsigned char* __restrict__ pok, int* __restrict__ key_ji,
                        int* __restrict__ theta) {
  const int rank = blockIdx.x * blockDim.x + threadIdx.x;
  if (rank >= Np) return;
  const int Np_pad = NCH * CHUNK;
  const float4* me = reinterpret_cast<const float4*>(table + (size_t)rank * ROW);
  const float4 m0 = me[0], m1 = me[1], m2 = me[2];
  const bool val = m1.w > 0.5f;
  const int ax = *axis_in;
  const float alo = ax == 0 ? m1.x : (ax == 1 ? m1.y : m1.z);
  const float ahi = ax == 0 ? m2.x : (ax == 1 ? m2.y : m2.z);
  const int mask = (1 << id_bits) - 1;
  int* mb = best + rank;
  for (int s = 0; s < K; ++s) mb[(size_t)s * Np_pad] = IMAX;
  int kth = IMAX;
  for (int ch = 0; val && ch < NCH; ++ch) {
    if (chunks[2 * ch] > ahi || chunks[2 * ch + 1] < alo) continue;   // no row of it can meet
    const int r1 = min((ch + 1) * CHUNK, Np);
    for (int r = ch * CHUNK; r < r1; ++r) {
      const float4* o = reinterpret_cast<const float4*>(table + (size_t)r * ROW);
      const float4 o0 = o[0], o1 = o[1], o2 = o[2];
      if (!(o1.w > 0.5f)) continue;
      const bool over = o1.x <= m2.x && m1.x <= o2.x && o1.y <= m2.y && m1.y <= o2.y &&
                        o1.z <= m2.z && m1.z <= o2.z;
      if (!over || o0.w == m0.w || o2.w == m2.w) continue;
      const float dx = o0.x - m0.x, dy = o0.y - m0.y, dz = o0.z - m0.z;
      float d2 = dx * dx;
      d2 = d2 + dy * dy;
      d2 = d2 + dz * dz;
      const int q = (int)fminf(d2 * qs, qmax);
      int v = (q << id_bits) | ((int)o2.w & mask);
      if (v >= kth) continue;
      for (int s = 0; s < K; ++s) {
        const int b = mb[(size_t)s * Np_pad];
        mb[(size_t)s * Np_pad] = min(b, v);
        v = max(b, v);
      }
      kth = mb[(size_t)(K - 1) * Np_pad];
    }
  }
  const int i = (int)m2.w;
  for (int s = 0; s < K; ++s) {
    const int key = mb[(size_t)s * Np_pad];
    pidx[(size_t)i * K + s] = key & mask;
    pok[(size_t)i * K + s] = key != IMAX;
    key_ji[(size_t)i * K + s] = (key & ~mask) | i;
  }
  theta[i] = kth;
}

}  // namespace

extern "C" int surtr_broadphase_exact_key(const float* c, int cs, const unsigned char* valid,
                                          int Np, float* key, float* params, int* axis,
                                          void* stream) {
  if (Np < 1) return (int)cudaErrorInvalidValue;
  bp_key_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(c, cs, valid, Np, key, params, axis);
  return (int)cudaGetLastError();
}

extern "C" int surtr_broadphase_exact_pack(const float* c, int cs, const float* lo, int ls,
                                           const float* hi, int hs, const int* owner,
                                           const unsigned char* valid, const int64_t* order,
                                           const float* params, const int* axis, int Np,
                                           int NCH, float* table, float* tiles, float* chunks,
                                           void* stream) {
  if (Np < 1 || NCH * CHUNK < Np) return (int)cudaErrorInvalidValue;
  bp_pack_kernel<<<NCH, CHUNK, 0, (cudaStream_t)stream>>>(c, cs, lo, ls, hi, hs, owner, valid,
                                                          order, params, axis, Np, table, tiles,
                                                          chunks);
  return (int)cudaGetLastError();
}

// variant 0, tiled: K <= MAXK; 1, long: the same sweep with lists of 32 or
// LONG_K keys, K <= LONG_K; 2, general: any K, with `best` a (K, NCH *
// CHUNK) int scratch and `axis` the key launch's axis.
extern "C" int surtr_broadphase_exact(const float* table, const float* tiles, const float* chunks,
                                      int Np, int NCH, int K, int id_bits, float qs, float qmax,
                                      int* pidx, unsigned char* pok, int* key_ji, int* theta,
                                      const int* axis, int* best, int variant, void* stream) {
  const int NT = NCH * (CHUNK / TILE);
  if (K < 1 || id_bits < 1 || id_bits > 30 || NT > MAX_TILES || variant < 0 || variant > 2 ||
      (variant == 0 && K > MAXK) || (variant == 1 && K > LONG_K) ||
      (variant == 2 && best == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Np == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 2)
    bp_exact_general_kernel<<<(Np + 127) / 128, 128, 0, st>>>(
        table, chunks, axis, Np, NCH, K, id_bits, qs, qmax, best, pidx, pok, key_ji, theta);
  else if (K <= MAXK)
    bp_exact_kernel<MAXK><<<NT, GROUPS * 32, 0, st>>>(
        table, tiles, chunks, Np, NT, NCH, K, id_bits, qs, qmax, pidx, pok, key_ji, theta);
  else if (K <= 32)
    bp_exact_kernel<32><<<NT, GROUPS * 32, 0, st>>>(
        table, tiles, chunks, Np, NT, NCH, K, id_bits, qs, qmax, pidx, pok, key_ji, theta);
  else
    bp_exact_kernel<LONG_K><<<NT, GROUPS * 32, 0, st>>>(
        table, tiles, chunks, Np, NT, NCH, K, id_bits, qs, qmax, pidx, pok, key_ji, theta);
  return (int)cudaGetLastError();
}
