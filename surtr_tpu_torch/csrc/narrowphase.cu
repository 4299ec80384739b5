// Pair narrowphase: SAT + containment manifold (kernel B7).
//
// Replaces: surtr_tpu/physics/narrowphase_pallas.py `_narrow_kernel`
// (wrapper `narrowphase_raw_pallas`). Semantics of the plain version in
// surtr_tpu_torch/physics/narrowphase_cuda.py `narrowphase_reference`: for
// the pair (piece i, its k-th broadphase candidate j), the penetration along
// the 13 DOP axes (interval overlap), j's faces (i's corners against j's
// planes), i's faces (j's corners against i's planes) and the Ne x Ne edge
// cross axes; the least penetration, first of ties in that order, gives the
// normal (j -> i) and depth. Then up to M contact points, deepest first and
// first of ties, from i's corners inside j and j's corners inside i (each
// moved half its depth along the normal), with the support-point fallback
// when none is contained, and each point's feature id. One output record of
// 5 + 6M floats per pair: nx ny nz depth hit, then per point
// val hit px py pz fid.
//
// What bounds it on the card: bytes, barely. Per pair it reads two packed
// rows (2 x 440 B at Vh = 8, F = 8, Ne = 3; the partner row from L2) and
// writes 116 B, and does ~2,600 flops (the 2 x Vh x F plane distances
// dominate). At 80,000 pairs: ~14 MB unique traffic and ~0.2 GFLOP.
// Design: one thread per pair; the K threads of one piece are neighbours in
// a warp, so the own row is one broadcast read; the partner row is read by
// index inside the kernel (the TPU version gathered it beforehand). The two
// corner sets, the containment maxima and the manifold scores live in
// registers (Vh is a template parameter and every register array is indexed
// by unrolled constants); planes and edges are streamed from the rows.
// Every pick walks candidates in the plain version's order and replaces
// only on a strictly better value, so ties resolve to the first, as
// jnp.argmin/argmax and torch.argmin/argmax do. Built with -fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.4e38f;
constexpr float HALF_BIG = 1.7e38f;  // BIG / 2, exact in binary

template <int VH>
__global__ void narrow_kernel(const float* __restrict__ packed, const int* __restrict__ pidx,
                              const uint8_t* __restrict__ pok, const float* __restrict__ dop,
                              int Np, int K, int F, int NE, int M, float slop,
                              float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= Np * K) return;
  const int i = p / K;
  int j = pidx[p];
  j = j < 0 ? 0 : (j >= Np ? Np - 1 : j);
  const int D = 4 * VH + 5 * F + 26 + 4 * NE;
  const float* I = packed + (size_t)i * D;
  const float* J = packed + (size_t)j * D;
  const int PN = 4 * VH, PD = PN + 3 * F, PM = PN + 4 * F;
  const int LOD = PN + 5 * F, HID = LOD + 13, EX = HID + 13, EM = EX + 3 * NE;

  float iv[3][VH], jv[3][VH];
  bool im[VH], jm[VH];
#pragma unroll
  for (int v = 0; v < VH; ++v) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      iv[c][v] = I[c * VH + v];
      jv[c][v] = J[c * VH + v];
    }
    im[v] = I[3 * VH + v] > 0.5f;
    jm[v] = J[3 * VH + v] > 0.5f;
  }

  // Running least penetration over the axis families, first of ties. A
  // masked axis counts BIG, or NaN when its penetration is not finite (an
  // edge axis against a piece with no live corner); a NaN axis leaves the
  // pair's depth NaN and its normal 0 (the JAX kernel's pen·mask +
  // (1 - mask)·BIG, min and one-hot pick).
  float depth = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  bool first = true, undefined = false;
  auto axis = [&](bool live, float pen, float dx, float dy, float dz) {
    if (!live) pen = isfinite(pen) ? BIG : NAN;
    if (isnan(pen)) { undefined = true; return; }
    if (first || pen < depth) { depth = pen; nx = dx; ny = dy; nz = dz; first = false; }
  };

  // (1) 26-DOP interval axes.
#pragma unroll
  for (int a = 0; a < 13; ++a) {
    const float ilo = I[LOD + a], ihi = I[HID + a], jlo = J[LOD + a], jhi = J[HID + a];
    const float ov = fminf(ihi, jhi) - fmaxf(ilo, jlo);
    const float s = (ihi + ilo) < (jhi + jlo) ? -1.0f : 1.0f;
    axis(true, ov, s * dop[a * 3 + 0], s * dop[a * 3 + 1], s * dop[a * 3 + 2]);
  }

  // (2) i's corners against j's planes; containment of i's corners in j.
  float ins_j[VH], ins_i[VH];
#pragma unroll
  for (int v = 0; v < VH; ++v) { ins_j[v] = -BIG; ins_i[v] = -BIG; }
  for (int f = 0; f < F; ++f) {
    const float px = J[PN + f], py = J[PN + F + f], pz = J[PN + 2 * F + f], pd = J[PD + f];
    const bool live = J[PM + f] > 0.5f;
    float mn = BIG;
#pragma unroll
    for (int v = 0; v < VH; ++v) {
      const float dist = ((iv[0][v] * px + iv[1][v] * py) + iv[2][v] * pz) + pd;
      if (im[v]) mn = fminf(mn, dist);
      if (live) ins_j[v] = fmaxf(ins_j[v], dist);
    }
    axis(live, -mn, px, py, pz);
  }
  // (3) j's corners against i's planes.
  for (int f = 0; f < F; ++f) {
    const float px = I[PN + f], py = I[PN + F + f], pz = I[PN + 2 * F + f], pd = I[PD + f];
    const bool live = I[PM + f] > 0.5f;
    float mn = BIG;
#pragma unroll
    for (int v = 0; v < VH; ++v) {
      const float dist = ((jv[0][v] * px + jv[1][v] * py) + jv[2][v] * pz) + pd;
      if (jm[v]) mn = fminf(mn, dist);
      if (live) ins_i[v] = fmaxf(ins_i[v], dist);
    }
    axis(live, -mn, -px, -py, -pz);
  }
  // (4) edge x edge cross axes, i's edge major.
  for (int a = 0; a < NE; ++a) {
    const float ax = I[EX + a], ay = I[EX + NE + a], az = I[EX + 2 * NE + a];
    const bool ia = I[EM + a] > 0.5f;
    for (int b = 0; b < NE; ++b) {
      const float bx = J[EX + b], by = J[EX + NE + b], bz = J[EX + 2 * NE + b];
      float cx = ay * bz - az * by;
      float cy = az * bx - ax * bz;
      float cz = ax * by - ay * bx;
      const float nl = sqrtf((cx * cx + cy * cy) + cz * cz);
      const float inv = 1.0f / fmaxf(nl, 1e-30f);
      cx = cx * inv; cy = cy * inv; cz = cz * inv;
      const bool live = ia && (J[EM + b] > 0.5f) && (nl > 1e-6f);
      float ilo = BIG, ihi = -BIG, jlo = BIG, jhi = -BIG;
#pragma unroll
      for (int v = 0; v < VH; ++v) {
        const float ti = (iv[0][v] * cx + iv[1][v] * cy) + iv[2][v] * cz;
        const float tj = (jv[0][v] * cx + jv[1][v] * cy) + jv[2][v] * cz;
        if (im[v]) { ilo = fminf(ilo, ti); ihi = fmaxf(ihi, ti); }
        if (jm[v]) { jlo = fminf(jlo, tj); jhi = fmaxf(jhi, tj); }
      }
      const float ov = fminf(ihi, jhi) - fmaxf(ilo, jlo);
      const float s = (ihi + ilo) < (jhi + jlo) ? -1.0f : 1.0f;
      axis(live, ov, cx * s, cy * s, cz * s);
    }
  }
  if (undefined) { depth = NAN; nx = 0.f; ny = 0.f; nz = 0.f; }
  const bool hit = (pok[p] != 0) && (depth > -slop) && (depth < HALF_BIG);

  // Containment manifold.
  float si[VH], sj[VH];
  float si_min = BIG, sj_max = -BIG;
#pragma unroll
  for (int v = 0; v < VH; ++v) {
    si[v] = (iv[0][v] * nx + iv[1][v] * ny) + iv[2][v] * nz;
    sj[v] = (jv[0][v] * nx + jv[1][v] * ny) + jv[2][v] * nz;
    if (im[v]) si_min = fminf(si_min, si[v]);
    if (jm[v]) sj_max = fmaxf(sj_max, sj[v]);
  }
  float sc[2 * VH];
#pragma unroll
  for (int v = 0; v < VH; ++v) {
    sc[v] = (ins_j[v] <= slop && im[v]) ? sj_max - si[v] : -BIG;
    sc[VH + v] = (ins_i[v] <= slop && jm[v]) ? sj[v] - si_min : -BIG;
  }

  const int R = 5 + 6 * M;
  float* o = out + (size_t)p * R;
  o[0] = nx; o[1] = ny; o[2] = nz; o[3] = depth; o[4] = hit ? 1.0f : 0.0f;
  bool any_h = false;
  float v0 = 0.f, x0 = 0.f, y0 = 0.f, z0 = 0.f, f0 = 0.f;
  bool h0 = false;
  for (int m = 0; m < M; ++m) {
    float mx = sc[0];
    int b = 0;
#pragma unroll
    for (int r = 1; r < 2 * VH; ++r)
      if (sc[r] > mx) { mx = sc[r]; b = r; }
    float px = 0.f, py = 0.f, pz = 0.f;
#pragma unroll
    for (int r = 0; r < 2 * VH; ++r) {
      if (r != b) continue;
      if (r < VH) {
        const float h = (sj_max - si[r]) * 0.5f;
        px = iv[0][r] + nx * h; py = iv[1][r] + ny * h; pz = iv[2][r] + nz * h;
      } else {
        const int v = r - VH;
        const float h = (sj[v] - si_min) * 0.5f;
        px = jv[0][v] - nx * h; py = jv[1][v] - ny * h; pz = jv[2][v] - nz * h;
      }
      sc[r] = -BIG;
    }
    const bool h = hit && (mx > -slop) && (mx < HALF_BIG);
    any_h = any_h || h;
    if (m == 0) {
      v0 = mx; h0 = h; x0 = px; y0 = py; z0 = pz; f0 = (float)(b + 1);
    } else {
      float* om = o + 5 + 6 * m;
      om[0] = mx; om[1] = h ? 1.0f : 0.0f; om[2] = px; om[3] = py; om[4] = pz;
      om[5] = (float)(b + 1);
    }
  }

  // Fallback when no corner is contained: the midpoint of the deepest
  // support corners, fid 2Vh + fi·Vh + fj + 1.
  if (hit && !any_h) {
    int fi = -1, fj = -1;
    float bi = 0.f, bj = 0.f;
#pragma unroll
    for (int v = 0; v < VH; ++v) {
      if (im[v] && (fi < 0 || -si[v] > bi)) { bi = -si[v]; fi = v; }
      if (jm[v] && (fj < 0 || sj[v] > bj)) { bj = sj[v]; fj = v; }
    }
    float pi[3] = {0.f, 0.f, 0.f}, pj[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int v = 0; v < VH; ++v) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (v == fi) pi[c] = iv[c][v];
        if (v == fj) pj[c] = jv[c][v];
      }
    }
    x0 = 0.5f * (pi[0] + pj[0]);
    y0 = 0.5f * (pi[1] + pj[1]);
    z0 = 0.5f * (pi[2] + pj[2]);
    v0 = depth;
    h0 = true;
    f0 = (2.0f * VH + (float)(fi < 0 ? 0 : fi) * VH) + (float)(fj < 0 ? 0 : fj + 1);
  }
  o[5] = v0; o[6] = h0 ? 1.0f : 0.0f; o[7] = x0; o[8] = y0; o[9] = z0; o[10] = f0;
}

template <int VH>
int launch(const float* packed, const int* pidx, const uint8_t* pok, const float* dop, int Np,
           int K, int F, int NE, int M, float slop, float* out, cudaStream_t stream) {
  const int threads = 128;
  const int pairs = Np * K;
  narrow_kernel<VH><<<(pairs + threads - 1) / threads, threads, 0, stream>>>(
      packed, pidx, pok, dop, Np, K, F, NE, M, slop, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Corner-pool sizes the kernel is built for (the wrapper checks first).
extern "C" int surtr_narrowphase_supports(int Vh) {
  return Vh == 8 || Vh == 16 || Vh == 32 || Vh == 64;
}

extern "C" int surtr_narrowphase(const float* packed, const int* pidx, const uint8_t* pok,
                                 const float* dop, int Np, int K, int Vh, int F, int Ne, int M,
                                 float slop, float* out, void* stream) {
  if (Np * K == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (Vh) {
    case 8: return launch<8>(packed, pidx, pok, dop, Np, K, F, Ne, M, slop, out, s);
    case 16: return launch<16>(packed, pidx, pok, dop, Np, K, F, Ne, M, slop, out, s);
    case 32: return launch<32>(packed, pidx, pok, dop, Np, K, F, Ne, M, slop, out, s);
    case 64: return launch<64>(packed, pidx, pok, dop, Np, K, F, Ne, M, slop, out, s);
    default: return -1;
  }
}
