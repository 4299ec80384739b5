// Tiled z-buffer raster of screen-space triangles (kernel B11).
//
// Replaces: surtr_tpu/render/raster_pallas.py `_raster_tile_kernel` (wrapper
// `rasterize_ids_pallas`). Input is the wrapper's tile-sorted table
// (surtr_tpu_torch/render/raster_cuda.py): attrs (T_pad, 10 + A) rows
// ax ay bx by cx cy za zb zc ok [+ A G-buffer columns] in chunks of 64 rows,
// the chunk screen boxes (nblk, 4) bx0 bx1 by0 by1 and per tile its chunk
// range [lo, hi). Per pixel it keeps the smallest
//   z = (w0 * za + w1 * zb) + w2 * zc,  w = e * inv_area,
// over triangles with w0, w1, w2 >= 0, ok, |area| > 1e-12 and 0 < z < 1,
// walking the tile's chunks in order and each chunk's triangles in order and
// replacing only on a strictly smaller z: the id is the first minimum, as the
// TPU kernel's per-chunk argmin and strict cross-chunk compare give it.
// Uncovered pixels keep BIG and -1; the G-buffer is the winner's attribute
// row, zeros on background (the TPU selects it with an exact one-hot product).
// Every product and sum is rounded on its own (built with -fmad=false, IEEE
// division), so the plain PyTorch version gives the same bits.
//
// What bounds it on the card: operations. Each (tile, chunk) pair that passes
// the box reject costs 64 triangles x 2,048 pixels x ~29 float operations
// (three edge functions, three weights, the depth, the tests); the table and
// the images are a few MB. Design, a simple first version: one CTA per
// 16 x 128 tile, 256 threads of 8 pixels each (pixel k = thread + 256 j, so
// stores are coalesced); per chunk of the tile's range a block-uniform box
// reject, then the chunk's rows and per-triangle terms (edge deltas, area,
// 1 / area, a live flag) staged in shared memory once for all pixels; depth
// and id in registers; depth, id and G-buffer written straight into the
// (H, W) and (H, W, A) images. A 512 x 512 image has 128 tiles, so 4 of the
// 132 SMs idle and each SM holds one CTA: a later redesign splits tiles or
// chunk ranges across more CTAs.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;
constexpr int TW = 128;
constexpr int CHUNK = 64;
constexpr int THREADS = 256;
constexpr int PPT = TH * TW / THREADS;  // pixels per thread
constexpr float BIG = 3.4e38f;

struct Tri {
  float ax, ay, bx, by, cx, cy, za, zb, zc;
  float cbx, cby, acx, acy, bax, bay;  // c - b, a - c, b - a
  float inv_area;
  int live;
};

__global__ void __launch_bounds__(THREADS)
raster_kernel(const float* __restrict__ attrs, const float* __restrict__ bbox,
              const int* __restrict__ rng, float* __restrict__ depth_out,
              int* __restrict__ tid_out, float* __restrict__ gbuf_out, int H, int W,
              int ntx, int A) {
  __shared__ Tri tri[CHUNK];
  const int t = blockIdx.x;
  const int ti = t / ntx;
  const int tj = t % ntx;
  const int D = 10 + A;
  const float tx0 = (float)(tj * TW), tx1 = tx0 + TW;
  const float ty0 = (float)(ti * TH), ty1 = ty0 + TH;

  float px[PPT], py[PPT], best[PPT];
  int id[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int k = threadIdx.x + THREADS * j;
    px[j] = (float)(k % TW + tj * TW) + 0.5f;
    py[j] = (float)(k / TW + ti * TH) + 0.5f;
    best[j] = BIG;
    id[j] = -1;
  }

  const int lo = rng[2 * t], hi = rng[2 * t + 1];
  for (int b = lo; b < hi; ++b) {
    const float cbx0 = bbox[4 * b], cbx1 = bbox[4 * b + 1];
    const float cby0 = bbox[4 * b + 2], cby1 = bbox[4 * b + 3];
    if (!(cbx0 <= tx1 && cbx1 >= tx0 && cby0 <= ty1 && cby1 >= ty0)) continue;
    __syncthreads();  // the previous chunk's reads are done
    if (threadIdx.x < CHUNK) {
      const float* r = attrs + (size_t)(b * CHUNK + threadIdx.x) * D;
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
      tri[threadIdx.x] = q;
    }
    __syncthreads();
    for (int i = 0; i < CHUNK; ++i) {
      const Tri& q = tri[i];
      if (!q.live) continue;  // block-uniform: every thread reads the same row
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const float e0 = q.cbx * (py[j] - q.by) - q.cby * (px[j] - q.bx);
        const float e1 = q.acx * (py[j] - q.cy) - q.acy * (px[j] - q.cx);
        const float e2 = q.bax * (py[j] - q.ay) - q.bay * (px[j] - q.ax);
        const float w0 = e0 * q.inv_area;
        const float w1 = e1 * q.inv_area;
        const float w2 = e2 * q.inv_area;
        const float z = (w0 * q.za + w1 * q.zb) + w2 * q.zc;
        if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f && z > 0.0f && z < 1.0f && z < best[j]) {
          best[j] = z;
          id[j] = b * CHUNK + i;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int k = threadIdx.x + THREADS * j;
    const int row = ti * TH + k / TW;
    const int col = tj * TW + k % TW;
    if (row >= H || col >= W) continue;
    const size_t p = (size_t)row * W + col;
    depth_out[p] = best[j];
    tid_out[p] = id[j];
    for (int a = 0; a < A; ++a)
      gbuf_out[p * A + a] = id[j] >= 0 ? attrs[(size_t)id[j] * D + 10 + a] : 0.0f;
  }
}

}  // namespace

extern "C" int surtr_raster(const float* attrs, const float* bbox, const int* rng,
                            float* depth, int* tid, float* gbuf, int H, int W, int ntx,
                            int nty, int A, void* stream) {
  if (A < 0 || (A > 0 && gbuf == nullptr)) return (int)cudaErrorInvalidValue;
  if (ntx * nty > 0)
    raster_kernel<<<ntx * nty, THREADS, 0, (cudaStream_t)stream>>>(
        attrs, bbox, rng, depth, tid, gbuf, H, W, ntx, A);
  return (int)cudaGetLastError();
}
