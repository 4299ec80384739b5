// Tiled z-buffer raster of screen-space triangles (kernel B11) and its glue.
//
// Replaces: surtr_tpu/render/raster_pallas.py `_raster_tile_kernel` (wrapper
// `rasterize_ids_pallas`), with the wrapper's sort and pack. Semantics of the
// plain versions in surtr_tpu_torch/render/raster_cuda.py: `_tile_table`
// (the glue) and `tile_raster_reference` (the raster). The table is (T_pad,
// 10 + A) rows ax ay bx by cx cy za zb zc ok [+ A G-buffer columns] sorted
// stably by the 16 x 128 tile of each triangle's bounding-box centre
// (invalid last), in chunks of 64 rows; each chunk has a screen box over its
// valid rows and each tile the range [lo, hi) of chunks whose box meets it.
// Per pixel the raster keeps the smallest
//   z = (w0 * za + w1 * zb) + w2 * zc,  w = e * inv_area,
// over live triangles (ok, |area| > 1e-12) with w0, w1, w2 >= 0 and
// 0 < z < 1 of the live (tile, chunk) pairs, and the first triangle in
// sorted order at that z, as the TPU kernel's per-chunk argmin and strict
// cross-chunk compare give it. Uncovered pixels keep BIG and -1; the
// G-buffer is the winner's attribute row, zeros on background.
//
// What bounds it on the card: operations, ~29 per (pixel, live triangle)
// test over the live pairs' 2,048 pixels (the frame's two calls: 0.068 ms
// at 67 TFLOP/s); the table and images are a few MB.
//
// The first design ran one CTA per tile walking its chunk range alone (128
// CTAs at 512 x 512), so the few dense tiles near the screen's centre, with
// 60-80 live pairs of 15-20 us each, paced the launch; and ~30 PyTorch ops
// of glue ran around it. It took 1.5-2.5 ms a frame on the device on an
// NVIDIA H100 80GB HBM3 at 700 W. This design:
//  - glue, two launches around one torch.sort (raster_cuda._glue_kernel):
//    raster_key_kernel writes the centre-tile key and sets the tile ranges
//    to (nblk, 0); raster_pack_kernel (one CTA per chunk) writes the sorted
//    rows, the chunk's box, and folds the chunk into the ranges of the
//    tiles its box meets with atomicMin / atomicMax; the last CTA sets the
//    ranges of tiles that no box meets to (nblk, nblk). No host sync;
//  - spread: a persistent grid of as many CTAs as the card holds. Each CTA
//    counts the live pairs of every tile (the tile's range, the box test),
//    scans them into a tile-major list and takes an equal contiguous slice
//    of it, so the dense tiles' pairs spread over many CTAs;
//  - exact merge: a CTA walks its pairs in order and replaces a pixel only
//    on a strictly smaller z, keeping (z, id) in registers. A tile whose
//    pairs all lie in the slice is written out directly. Otherwise the
//    partial goes into a per-tile 64-bit image by atomicMax of the inverted
//    key ~((float_bits(z) << 32) | id): positive floats order as their bits
//    and ids rise in walk order, so the largest inverted key is the
//    smallest z and, on equal z, the first triangle. The CTA that completes
//    a tile's pair count (a per-tile atomic counter) writes the tile out;
//  - fewer operations per test with the same bits: each thread owns 2 rows
//    x 4 columns of its tile (a warp an 8 x 32 block), so the edge
//    functions' per-row products dx_edge * (py - y) and per-column products
//    dy_edge * (px - x) are computed once per triangle and row or column,
//    and each pixel takes one subtraction per edge; the depth is computed
//    only when one of the thread's pixels passes the three weight tests (a
//    pixel that fails them is rejected whatever its depth), which a whole
//    warp skips for most triangles of a chunk; the tests 0 < z < 1 and
//    z < best fold into 0 < z < min(best, 1).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/time_b9_b11.py, the
// interactive frame's two calls, 691 and 610 live pairs, 93 in the densest
// tile; the first design in the same call): the kernel 0.195 ms a frame on
// the device against 3.39 ms, the glue 0.10 ms in 38 device launches
// against 0.39 ms in 196. Of that, the depth skip took the kernel from 0.28
// to 0.23 ms and the ballot walk of a tile's chunks to 0.195 ms.
// The resident kernel's step 1 is paid in every CTA: each counts all the
// screen's tiles (8,192 at a 4,096² shadow map: 1,024 a warp) and scans
// their offsets in its shared memory, which also caps it at 10,239 tiles.
// The global variant (raster_kernel<true>, the reference's shadow maps of
// 4,096² and 8,192², SurtrArgument.h:36) computes them once: a count
// launch on the raster's grid (a warp a tile; CTA c also zeroes key slot
// c), a one-CTA scan into device memory, then one raster launch whose CTAs
// find their slice by binary search in the global offsets and step to the
// next live tile by ballots over 32 offsets. A tile that a slice boundary
// splits merges in the key slot of the first boundary inside it, c =
// ceil((start[t] + 1) G / L), so the key scratch holds one 16 KB image a
// CTA (at most 8 an SM: 17 MB), whatever the screen, and is zeroed by the
// count launch (no memset). Merge, completion count and write-out are the
// resident kernel's. Bound: the same operations of the live pairs. Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (tools/time_b9_b11.py
// --shadow-maps, device ms, the previous design in the same call): at
// 8,192², bench_render's first 512 triangles (20,572 live pairs) 2.07 ms
// in 1 raster launch against 3.92-3.94 in 8 (and 0.037 ms of count and
// scan against 0.170 of memsets; bound 1.167), its 4,096 triangles
// (110,352 pairs) 10.48-10.51 against 11.96-12.04; at 4,096² (29,129
// pairs) 2.77 against the resident kernel's 3.12-3.17, at 2,048² 0.77
// against 0.85, at 1,024² 0.234 against 0.248, at 640² (200 tiles) 0.128
// against 0.130, at 512² (128 tiles) 0.1035 against 0.102, count and scan
// included: the wrapper takes the resident kernel up to 157 tiles, the
// interpolated crossover (raster_cuda.RESIDENT_TILES), this variant past it.
// No per-triangle reject finer than the chunk box: a sliver with |area|
// just above 1e-12 can cover far pixels through rounding, so a triangle
// bounding-box skip could change bits. Every product and sum is rounded on
// its own (built with -fmad=false, IEEE division), so the plain PyTorch
// version gives the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;
constexpr int TW = 128;
constexpr int CHUNK = 64;
constexpr int THREADS = 256;
// A warp owns an 8 x 32 block of its tile (warps in 2 rows of 4), a thread
// 2 rows x 4 columns of it (lanes in 4 rows of 8).
constexpr int RPT = 2;
constexpr int CPT = 4;
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// Glue.
// ---------------------------------------------------------------------------

// Tile index of a bounding-box centre as the plain version computes it:
// floor division by the tile size (torch.floor_divide: NaN for a non-finite
// value), clamped to [0, n - 1] with NaN kept, converted as the card converts
// float to int32 (NaN to 0).
__device__ inline int tile_of(float c, float size, int n) {
  float q = isfinite(c) ? floorf(c / size) : NAN;
  if (q != q) return 0;
  return (int)fminf(fmaxf(q, 0.0f), (float)(n - 1));
}

__global__ void raster_key_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                                  const bool* __restrict__ ok, int T, int ntx, int nty,
                                  int nblk, int* __restrict__ key, int* __restrict__ rng,
                                  unsigned* __restrict__ done) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < T) {
    const float cx = ((sx[3 * i] + sx[3 * i + 1]) + sx[3 * i + 2]) / 3.0f;
    const float cy = ((sy[3 * i] + sy[3 * i + 1]) + sy[3 * i + 2]) / 3.0f;
    key[i] = ok[i] ? tile_of(cy, (float)TH, nty) * ntx + tile_of(cx, (float)TW, ntx) : (1 << 30);
  }
  if (i < ntx * nty) {
    rng[2 * i] = nblk;
    rng[2 * i + 1] = 0;
  }
  if (i == 0) *done = 0u;
}

// min / max that keep a NaN, as torch.amin / amax do.
__device__ inline float nan_min(float a, float b) { return (a != a || b != b) ? NAN : fminf(a, b); }
__device__ inline float nan_max(float a, float b) { return (a != a || b != b) ? NAN : fmaxf(a, b); }

__device__ inline bool meets(float bx0, float bx1, float by0, float by1, float tx0, float ty0) {
  return bx0 <= tx0 + TW && bx1 >= tx0 && by0 <= ty0 + TH && by1 >= ty0;
}

__global__ void __launch_bounds__(CHUNK)
raster_pack_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                   const float* __restrict__ sz, const bool* __restrict__ ok,
                   const float* __restrict__ attr, int A, const int64_t* __restrict__ order,
                   int T, int nblk, int ntx, int ntiles, float* __restrict__ attrs,
                   float* __restrict__ bbox, int* __restrict__ rng, unsigned* __restrict__ done) {
  __shared__ float part[4][CHUNK / 32];
  __shared__ float box[4];
  __shared__ bool last;
  const int b = blockIdx.x, r = threadIdx.x, i = b * CHUNK + r, D = 10 + A;
  float* row = attrs + (size_t)i * D;
  float m[4] = {BIG, -BIG, BIG, -BIG};  // x min, x max, y min, y max
  if (i < T) {
    const int64_t s = order[i];
    const float x0 = sx[3 * s], x1 = sx[3 * s + 1], x2 = sx[3 * s + 2];
    const float y0 = sy[3 * s], y1 = sy[3 * s + 1], y2 = sy[3 * s + 2];
    const bool v = ok[s];
    row[0] = x0; row[1] = y0; row[2] = x1; row[3] = y1; row[4] = x2; row[5] = y2;
    row[6] = sz[3 * s]; row[7] = sz[3 * s + 1]; row[8] = sz[3 * s + 2];
    row[9] = v ? 1.0f : 0.0f;
    for (int a = 0; a < A; ++a) row[10 + a] = attr[(size_t)s * A + a];
    if (v) {
      m[0] = nan_min(nan_min(x0, x1), x2);
      m[1] = nan_max(nan_max(x0, x1), x2);
      m[2] = nan_min(nan_min(y0, y1), y2);
      m[3] = nan_max(nan_max(y0, y1), y2);
    }
  } else {
    for (int d = 0; d < D; ++d) row[d] = 0.0f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m[0] = nan_min(m[0], __shfl_xor_sync(FULL, m[0], off));
    m[1] = nan_max(m[1], __shfl_xor_sync(FULL, m[1], off));
    m[2] = nan_min(m[2], __shfl_xor_sync(FULL, m[2], off));
    m[3] = nan_max(m[3], __shfl_xor_sync(FULL, m[3], off));
  }
  if (r % 32 == 0)
    for (int k = 0; k < 4; ++k) part[k][r / 32] = m[k];
  __syncthreads();
  if (r == 0) {
    box[0] = nan_min(part[0][0], part[0][1]);
    box[1] = nan_max(part[1][0], part[1][1]);
    box[2] = nan_min(part[2][0], part[2][1]);
    box[3] = nan_max(part[3][0], part[3][1]);
    for (int k = 0; k < 4; ++k) bbox[4 * b + k] = box[k];
  }
  __syncthreads();
  for (int t = r; t < ntiles; t += CHUNK) {
    const float tx0 = (float)(t % ntx) * TW, ty0 = (float)(t / ntx) * TH;
    if (meets(box[0], box[1], box[2], box[3], tx0, ty0)) {
      atomicMin(&rng[2 * t], b);
      atomicMax(&rng[2 * t + 1], b + 1);
    }
  }
  // The last CTA to finish sets the ranges that no chunk met to (nblk, nblk).
  __threadfence();
  __syncthreads();
  if (r == 0) last = atomicAdd(done, 1u) == (unsigned)(nblk - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int t = r; t < ntiles; t += CHUNK) {
    const int lo = __ldcg(&rng[2 * t]), hi = __ldcg(&rng[2 * t + 1]);
    if (hi < lo) rng[2 * t + 1] = lo;
  }
}

// ---------------------------------------------------------------------------
// The raster.
// ---------------------------------------------------------------------------

struct Tri {
  float ax, ay, bx, by, cx, cy, za, zb, zc;
  float cbx, cby, acx, acy, bax, bay;  // c - b, a - c, b - a
  float inv_area;
  int live;
};

struct Args {
  const float* attrs;
  const float* bbox;
  const int* rng;
  const int64_t* order;  // sorted row -> caller's index, or null (sorted-domain ids)
  int T;
  float* depth;
  int* tid;
  float* gbuf;
  unsigned long long* keys;  // (tiles or key slots, 2048) inverted keys, 0 = untouched
  unsigned* count;           // (tiles or key slots,) pairs merged into keys
  int H, W, ntx, nty, A;
  const int* start;          // the global variant: (ntiles + 1) offsets in device memory
};

// Exclusive prefix sum of a[0..n) in shared memory, in place.
__device__ void block_scan(int* a, int n) {
  __shared__ int wsum[THREADS / 32];
  const int per = (n + THREADS - 1) / THREADS;
  const int b0 = min(n, (int)threadIdx.x * per), b1 = min(n, b0 + per);
  int s = 0;
  for (int i = b0; i < b1; ++i) s += a[i];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < THREADS / 32 ? wsum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += y;
    }
    if (lane < THREADS / 32) wsum[lane] = v;
  }
  __syncthreads();
  int excl = x - s + (warp ? wsum[warp - 1] : 0);
  for (int i = b0; i < b1; ++i) {
    const int v = a[i];
    a[i] = excl;
    excl += v;
  }
  __syncthreads();
}

__device__ inline bool pair_live(const float* bbox, int b, int t, int ntx) {
  const float4 q = reinterpret_cast<const float4*>(bbox)[b];
  return meets(q.x, q.y, q.z, q.w, (float)(t % ntx) * TW, (float)(t / ntx) * TH);
}

// Writes tile t's pixels: thread-owned (z, id) pairs, id -1 for background.
__device__ inline void write_pixel(const Args& g, int t, int k, float z, int id) {
  const int row = (t / g.ntx) * TH + k / TW, col = (t % g.ntx) * TW + k % TW;
  if (row >= g.H || col >= g.W) return;
  const size_t p = (size_t)row * g.W + col;
  const bool hit = id >= 0;
  g.depth[p] = hit ? z : BIG;
  int out = id;
  if (g.order) out = (hit && id < g.T) ? (int)g.order[id] : -1;
  g.tid[p] = out;
  const float* src = g.attrs + (size_t)(hit ? id : 0) * (10 + g.A) + 10;
  for (int a = 0; a < g.A; ++a) g.gbuf[p * g.A + a] = hit ? src[a] : 0.0f;
}

// The global variant's offsets, first launch (a grid of the raster's size):
// CTA c zeroes key slot c and its count; the warps count the live pairs of
// the tiles, a warp a tile, into start[t].
__global__ void __launch_bounds__(THREADS)
raster_count_kernel(const float* __restrict__ bbox, const int* __restrict__ rng, int ntx,
                    int ntiles, int* __restrict__ start, unsigned long long* __restrict__ keys,
                    unsigned* __restrict__ count) {
  const int lane = threadIdx.x % 32;
  ulonglong2* kz = reinterpret_cast<ulonglong2*>(keys + (size_t)blockIdx.x * TH * TW);
  for (int k = threadIdx.x; k < TH * TW / 2; k += THREADS) kz[k] = make_ulonglong2(0ull, 0ull);
  if (threadIdx.x == 0) count[blockIdx.x] = 0u;
  const int nw = gridDim.x * (THREADS / 32);
  for (int t = blockIdx.x * (THREADS / 32) + threadIdx.x / 32; t < ntiles; t += nw) {
    const int hi = rng[2 * t + 1];
    int n = 0;
    for (int b = rng[2 * t] + lane; b < hi; b += 32) n += pair_live(bbox, b, t, ntx);
    n = __reduce_add_sync(FULL, n);
    if (lane == 0) start[t] = n;
  }
}

// Second launch, one CTA: the exclusive prefix sum of start[0..n) in place,
// SCAN_PER consecutive entries a thread a pass; start[n] = the total.
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_PER = 8;

__global__ void __launch_bounds__(SCAN_THREADS) raster_scan_kernel(int* __restrict__ start, int n) {
  __shared__ int wsum[SCAN_THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int carry = 0;
  for (int base = 0; base < n; base += SCAN_THREADS * SCAN_PER) {
    const int i0 = base + threadIdx.x * SCAN_PER;
    int v[SCAN_PER], s = 0;
#pragma unroll
    for (int j = 0; j < SCAN_PER; ++j) {
      v[j] = i0 + j < n ? start[i0 + j] : 0;
      s += v[j];
    }
    int x = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = wsum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, w, off);
        if (lane >= off) w += y;
      }
      wsum[lane] = w;
    }
    __syncthreads();
    int excl = carry + x - s + (warp ? wsum[warp - 1] : 0);
#pragma unroll
    for (int j = 0; j < SCAN_PER; ++j) {
      if (i0 + j < n) start[i0 + j] = excl;
      excl += v[j];
    }
    carry += wsum[SCAN_THREADS / 32 - 1];
    __syncthreads();  // wsum is read above before the next pass writes it
  }
  if (threadIdx.x == 0) start[n] = carry;
}

// The first tile after t whose pairs reach past p (start[t' + 1] > p), 32
// tiles a step by ballot; one exists while p < start[ntiles].
__device__ inline int next_tile(const int* start, int t, int p, int ntiles) {
  const int lane = threadIdx.x % 32;
  for (int base = t + 1;; base += 32) {
    const int u = base + lane;
    const unsigned m = __ballot_sync(FULL, u < ntiles && start[u + 1] > p);
    if (m) return base + __ffs(m) - 1;
  }
}

// RESIDENT (GLOBAL false; up to RESIDENT_TILES tiles): each CTA computes the
// offsets itself into shared memory (step 1) and a tile split between CTAs
// merges in its own key image. GLOBAL (any screen): the offsets come from
// raster_count_kernel and raster_scan_kernel in device memory, and a split
// tile merges in the key slot of the first slice boundary inside it, so the
// key scratch has one slot a CTA, whatever the screen.
template <bool GLOBAL>
__global__ void __launch_bounds__(THREADS) raster_kernel(Args g) {
  extern __shared__ int s_start[];  // resident: (ntiles + 1) tile-major live-pair offsets
  __shared__ Tri tri[2][CHUNK];
  __shared__ int s_last;
  const int ntiles = g.ntx * g.nty;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = (warp / 4) * 8 + (lane / 8) * RPT;   // the thread's first tile row
  const int col0 = (warp % 4) * 32 + (lane % 8) * CPT;  // and first tile column
  const int* start = GLOBAL ? g.start : s_start;

  // 1. Live pairs per tile (a warp per tile, lanes over its chunk range),
  //    then the offsets of the tile-major list.
  if (!GLOBAL) {
    for (int t = warp; t < ntiles; t += THREADS / 32) {
      const int hi = g.rng[2 * t + 1];
      int n = 0;
      for (int b = g.rng[2 * t] + lane; b < hi; b += 32)
        n += pair_live(g.bbox, b, t, g.ntx);
      n = __reduce_add_sync(FULL, n);
      if (lane == 0) s_start[t] = n;
    }
    if (threadIdx.x == 0) s_start[ntiles] = 0;
    __syncthreads();
    block_scan(s_start, ntiles + 1);
  }
  const int L = start[ntiles];

  // 2. Tiles with no live pair are background; CTA c takes tiles c, c + G,
  //    ... (global: warp w of CTA c tiles 8c + w, 8c + w + 8G, ...).
  if (GLOBAL) {
    for (int t = blockIdx.x * (THREADS / 32) + warp; t < ntiles; t += gridDim.x * (THREADS / 32))
      if (start[t + 1] == start[t])
        for (int k = lane; k < TH * TW; k += 32) write_pixel(g, t, k, BIG, -1);
  } else {
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x)
      if (start[t + 1] == start[t])
        for (int k = threadIdx.x; k < TH * TW; k += THREADS) write_pixel(g, t, k, BIG, -1);
  }

  // 3. This CTA's slice of the list.
  const int s0 = (int)((long long)L * blockIdx.x / gridDim.x);
  const int s1 = (int)((long long)L * (blockIdx.x + 1) / gridDim.x);
  if (s0 >= s1) return;
  int t = 0;
  for (int lo = 0, hi = ntiles - 1; lo <= hi;) {  // last tile with start <= s0
    const int mid = (lo + hi) / 2;
    if (start[mid] <= s0) { t = mid; lo = mid + 1; } else { hi = mid - 1; }
  }
  int skip = s0 - start[t];
  int par = 0;
  for (int p = s0; p < s1;) {
    const int cnt = start[t + 1] - start[t];
    const int n_here = min(cnt - skip, s1 - p);
    const bool whole = skip == 0 && n_here == cnt;
    const int ti = t / g.ntx, tj = t % g.ntx;
    float px[CPT], py[RPT], thr[RPT][CPT];
    int id[RPT][CPT];
#pragma unroll
    for (int k = 0; k < CPT; ++k) px[k] = (float)(col0 + k + tj * TW) + 0.5f;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      py[j] = (float)(row0 + j + ti * TH) + 0.5f;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        thr[j][k] = 1.0f;
        id[j][k] = -1;
      }
    }
    // The tile's live chunks 32 at a time: each warp ballots the same 32
    // tests, so the walk below is uniform over the block.
    const int hi = g.rng[2 * t + 1];
    int seen = 0, done = 0;
    for (int b0 = g.rng[2 * t]; b0 < hi && done < n_here; b0 += 32) {
      unsigned live =
          __ballot_sync(FULL, b0 + lane < hi && pair_live(g.bbox, b0 + lane, t, g.ntx));
      if (seen + __popc(live) <= skip) {
        seen += __popc(live);
        continue;
      }
      for (; live && done < n_here; live &= live - 1) {
        const int b = b0 + __ffs(live) - 1;
        if (seen++ < skip) continue;
        ++done;
        Tri* buf = tri[par];
        par ^= 1;
        if (threadIdx.x < CHUNK) {
          const float* r = g.attrs + (size_t)(b * CHUNK + threadIdx.x) * (10 + g.A);
          Tri q;
          q.ax = r[0]; q.ay = r[1]; q.bx = r[2]; q.by = r[3]; q.cx = r[4]; q.cy = r[5];
          q.za = r[6]; q.zb = r[7]; q.zc = r[8];
          q.cbx = q.cx - q.bx; q.cby = q.cy - q.by;
          q.acx = q.ax - q.cx; q.acy = q.ay - q.cy;
          q.bax = q.bx - q.ax; q.bay = q.by - q.ay;
          const float area = q.bax * (q.cy - q.ay) - q.bay * (q.cx - q.ax);
          const bool big = fabsf(area) > 1e-12f;
          q.inv_area = big ? 1.0f / area : 0.0f;
          q.live = (r[9] > 0.5f) && big;
          buf[threadIdx.x] = q;
        }
        __syncthreads();  // one barrier a chunk: the other buffer was read two chunks ago
        for (int i = 0; i < CHUNK; ++i) {
          const Tri& q = buf[i];
          if (!q.live) continue;  // block-uniform: every thread reads the same row
          float e0r[RPT], e1r[RPT], e2r[RPT], e0c[CPT], e1c[CPT], e2c[CPT];
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            e0r[j] = q.cbx * (py[j] - q.by);
            e1r[j] = q.acx * (py[j] - q.cy);
            e2r[j] = q.bax * (py[j] - q.ay);
          }
#pragma unroll
          for (int k = 0; k < CPT; ++k) {
            e0c[k] = q.cby * (px[k] - q.bx);
            e1c[k] = q.acy * (px[k] - q.cx);
            e2c[k] = q.bay * (px[k] - q.ax);
          }
          // The weights of the thread's pixels; the depth only where a pixel
          // passes the weight tests (a pixel that fails them is rejected
          // whatever its depth, so skipping it changes no bit).
          float w0[RPT][CPT], w1[RPT][CPT], w2[RPT][CPT];
          bool any = false;
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
#pragma unroll
            for (int k = 0; k < CPT; ++k) {
              w0[j][k] = (e0r[j] - e0c[k]) * q.inv_area;
              w1[j][k] = (e1r[j] - e1c[k]) * q.inv_area;
              w2[j][k] = (e2r[j] - e2c[k]) * q.inv_area;
              any |= w0[j][k] >= 0.0f && w1[j][k] >= 0.0f && w2[j][k] >= 0.0f;
            }
          }
          if (!any) continue;
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
#pragma unroll
            for (int k = 0; k < CPT; ++k) {
              const float z = (w0[j][k] * q.za + w1[j][k] * q.zb) + w2[j][k] * q.zc;
              if (w0[j][k] >= 0.0f && w1[j][k] >= 0.0f && w2[j][k] >= 0.0f && z > 0.0f &&
                  z < thr[j][k]) {
                thr[j][k] = z;
                id[j][k] = b * CHUNK + i;
              }
            }
          }
        }
      }
    }

    if (whole) {
#pragma unroll
      for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int k = 0; k < CPT; ++k)
          write_pixel(g, t, (row0 + j) * TW + col0 + k, thr[j][k], id[j][k]);
    } else {
      // A split tile's key image: its own (resident), or the slot of the
      // first slice boundary c inside it, c = ceil((start[t] + 1) G / L).
      const int slot =
          GLOBAL ? (int)((((long long)start[t] + 1) * gridDim.x + L - 1) / L) : t;
      unsigned long long* kt = g.keys + (size_t)slot * TH * TW;
#pragma unroll
      for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int k = 0; k < CPT; ++k)
          if (id[j][k] >= 0)
            atomicMax(&kt[(row0 + j) * TW + col0 + k],
                      ~(((unsigned long long)__float_as_uint(thr[j][k]) << 32) |
                        (unsigned)id[j][k]));
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) s_last = atomicAdd(&g.count[slot], (unsigned)n_here) + n_here == cnt;
      __syncthreads();
      if (s_last) {
        __threadfence();
        for (int k = threadIdx.x; k < TH * TW; k += THREADS) {
          const unsigned long long v = ~__ldcg(&kt[k]);
          const bool hit = v != ~0ull;
          write_pixel(g, t, k, hit ? __uint_as_float((unsigned)(v >> 32)) : BIG,
                      hit ? (int)(v & 0xffffffffu) : -1);
        }
      }
    }
    p += n_here;
    skip = 0;
    if (GLOBAL) {
      if (p < s1) t = next_tile(start, t, p, ntiles);
    } else {
      do { ++t; } while (p < s1 && start[t + 1] == start[t]);
    }
  }
}

int g_sms = 0;

// Bytes of the global variant's scratch: the (ntiles + 1) offsets, rounded
// up to 16 bytes, then `slots` key images of 2,048 64-bit keys and `slots`
// 32-bit counts.
long long global_bytes(int ntiles, int slots) {
  const long long off = ((long long)(ntiles + 1) * 4 + 15) / 16 * 16;
  return off + (long long)slots * (TH * TW * 8 + 4);
}

}  // namespace

extern "C" int surtr_raster_key(const float* sx, const float* sy, const bool* ok, int T, int ntx,
                                int nty, int nblk, int* key, int* rng, unsigned* done,
                                void* stream) {
  const int n = T > ntx * nty ? T : ntx * nty;
  raster_key_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(sx, sy, ok, T, ntx, nty,
                                                                        nblk, key, rng, done);
  return (int)cudaGetLastError();
}

extern "C" int surtr_raster_pack(const float* sx, const float* sy, const float* sz,
                                 const bool* ok, const float* attr, int A, const int64_t* order,
                                 int T, int nblk, int ntx, int nty, float* attrs, float* bbox,
                                 int* rng, unsigned* done, void* stream) {
  if (A < 0 || (A > 0 && attr == nullptr) || nblk <= 0) return (int)cudaErrorInvalidValue;
  raster_pack_kernel<<<nblk, CHUNK, 0, (cudaStream_t)stream>>>(
      sx, sy, sz, ok, attr, A, order, T, nblk, ntx, ntx * nty, attrs, bbox, rng, done);
  return (int)cudaGetLastError();
}


extern "C" long long surtr_raster_global_bytes(int ntiles, int slots) {
  return global_bytes(ntiles, slots);
}

// variant 0, resident: scratch is (ntiles, 2048) 64-bit keys then (ntiles,)
// 32-bit counts, set to 0 here by one memset; the offsets live in each CTA's
// shared memory (at most 40 KB: 10,239 tiles). variant 1, global: scratch
// is `global_bytes(ntiles, slots)` bytes, slots >= the grid (the key slots
// and counts are zeroed by the count launch, no memset); three launches:
// count, scan, raster. *launched counts the raster kernel's launches.
extern "C" int surtr_raster(const float* attrs, const float* bbox, const int* rng,
                            const int64_t* order, int T, float* depth, int* tid, float* gbuf,
                            void* scratch, int H, int W, int ntx, int nty, int A, int variant,
                            int slots, int* launched, void* stream) {
  *launched = 0;
  if (A < 0 || (A > 0 && gbuf == nullptr) || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  const int ntiles = ntx * nty;
  if (ntiles <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int per_sm = 0;
  if (variant == 1) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raster_kernel<true>, THREADS, 0);
    const int grid = (per_sm > 0 ? per_sm : 1) * g_sms;
    if (grid > slots) return (int)cudaErrorInvalidValue;
    int* start = (int*)scratch;
    const long long off = global_bytes(ntiles, 0);
    unsigned long long* keys = (unsigned long long*)((char*)scratch + off);
    unsigned* count = (unsigned*)(keys + (size_t)slots * TH * TW);
    raster_count_kernel<<<grid, THREADS, 0, st>>>(bbox, rng, ntx, ntiles, start, keys, count);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    raster_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(start, ntiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const Args g{attrs, bbox, rng, order, T, depth, tid, gbuf, keys, count, H, W, ntx, nty, A,
                 start};
    raster_kernel<true><<<grid, THREADS, 0, st>>>(g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    *launched = 1;
    return 0;
  }
  const size_t smem = (size_t)(ntiles + 1) * sizeof(int);
  if (smem > 40 * 1024) return (int)cudaErrorInvalidValue;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raster_kernel<false>, THREADS, smem);
  const int grid = (per_sm > 0 ? per_sm : 1) * g_sms;
  unsigned long long* keys = (unsigned long long*)scratch;
  unsigned* count = (unsigned*)(keys + (size_t)ntiles * TH * TW);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)ntiles * (TH * TW * 8 + 4), st);
  if (e != cudaSuccess) return (int)e;
  const Args g{attrs, bbox, rng, order, T, depth, tid, gbuf, keys, count, H, W, ntx, nty, A,
               nullptr};
  raster_kernel<false><<<grid, THREADS, smem, st>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  return 0;
}
