// Morton-window broadphase with the mutual mask (kernel B12) and its glue.
//
// Replaces: surtr_tpu/physics/broadphase_pallas.py `_bp_kernel` (wrapper
// `broadphase_sorted_pallas`). Semantics of the plain version in
// surtr_tpu_torch/physics/broadphase_cuda.py `broadphase_sorted_reference`:
// pieces sorted by Morton code (stable) into a table; sorted lane r scans
// its 2W candidates in delta order [+1..+W, -1..-W]; a candidate r + d
// inside [0, Np) scores -d² (d² = ((dx·dx) + dy·dy) + dz·dz, own center
// minus the candidate's) when the AABBs overlap, both are valid and the
// owners differ, else -BIG. The lane keeps the K best (stable: ties, and
// filler at -BIG, go to the earliest delta). Slot k names the piece at rank
// clamp(r + d, 0, Np - 1) and is live when its score is real and the
// partner lane r + d selected its own -d slot (mutual).
//
// Four launches and one torch.sort (`broadphase_cuda._sorted_launch`):
//  1. bp_sorted_glue_key_kernel (a cooperative grid of up to 256 CTAs):
//     each CTA reduces the valid extent of its grid-stride rows
//     (bp_extent.cuh, as B6's key launch does for the whole pool), a grid
//     barrier, then every CTA reduces the parts and writes its rows' 30-bit
//     Morton codes, as `broadphase.morton` computes them (0x7FFFFFFF for
//     invalid rows);
//  2. torch.sort(codes, stable=True) in PyTorch, as the JAX package keeps
//     its argsort in XLA;
//  3. bp_sorted_glue_pack_kernel: the sorted (Np, 12) table [center 3 |
//     owner | lo 3 | valid | hi 3 | piece id as int bits], three 16-byte
//     stores a row;
//  4. bp_sorted_sweep_select_kernel: one warp a sorted lane; lane t scores
//     the candidates t, t + 32, ... (at W = 32: deltas +(t+1) and -(t+1));
//     the K best by K rounds of a warp max (redux) on an order-preserving
//     key of the score, then a warp min of the candidate index among the
//     maxima: the plain version's stable descending sort. It writes pidx,
//     each slot's candidate index and real flag, and the lane's 2W-bit
//     selection mask (ballots);
//     past its sizes (K > 16 or W > 128) bp_sorted_list_select_kernel: a
//     warp a sorted lane too, each lane's candidates scored once and kept
//     in order (registers up to W = 128, a list a lane in shared memory or
//     a device scratch beyond), so a round costs the winning lane one step;
//  5. bp_sorted_sweep_mutual_kernel: one thread a (lane, slot): live when
//     real and the partner lane's mask holds -d.
// The plain mirror of 1-3 is `broadphase_cuda.sorted_glue`, of 4 and 5
// `window_selection` and `window_mutual`. No step syncs with the host.
//
// What bounds the function on the card: its bytes, ~117 B a piece in and
// out at K = 8 (1.2 MB at the 10k lattice, 0.35 µs at 3.35 TB/s); the
// window test is ~25 operations a candidate, Np · 2W candidates (0.6 M at
// 10k, ~0.2 µs at the FP32 rate). The first design (one 128-thread CTA per
// 128 sorted lanes, each also selecting for its W-lane halos, one thread
// walking a lane's 2W candidates with a K-slot insertion; 78 device
// launches of PyTorch glue) took 0.134 ms for the sweep and 0.146 ms of
// glue a call at the 10k lattice. This design puts every sorted lane on
// its own warp (10,000 warps at 10k, against 79 CTAs), so no lane is
// selected twice; the mutual test reads the partners' masks in a second
// launch, since blocks run in no order. The selection issues instructions
// faster than its loads arrive, so its code is sized to the window: a
// template on the candidates a thread (2 for the paths' W <= 32, 8 up to
// W <= 128), each read straight from the table (staging the CTA's rows in
// shared memory measured no faster). Measured by tools/time_b10_b12.py on an NVIDIA H100 80GB
// HBM3 at 700 W, the first design in the same call: at the 10k lattice the
// sweep 0.0100 ms (the selection 0.0083) against 0.134, the glue 0.051
// (codes 0.0055, table 0.0019, the rest the sort) against 0.146, 18 device
// launches (14 of them the sort) against 78; at 66,000 pieces the sweep
// 0.043 against 0.061 and the glue 0.056 against 0.162 (a one-CTA key
// launch took 0.074 there). Built with -fmad=false: d² rounds as in the
// plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "bp_extent.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MAXK = 16;
constexpr int MAXW = 128;
constexpr int WARPS = 8;              // sorted lanes (warps) a CTA of the select launch
constexpr int KEY_THREADS = 1024;
constexpr int MAX_KEY_BLOCKS = 256;  // parts the wrapper's scratch holds
constexpr int ROW4 = 3;               // float4s a table row
constexpr int CODE_INVALID = 0x7FFFFFFF;
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

__device__ inline int delta_of(int c, int W) { return c < W ? c + 1 : W - 1 - c; }

// Order-preserving key of a float: a larger float gives a larger key
// (finite values and infinities; -0 and +0 differ, and only -0 occurs).
__device__ inline unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ inline float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ inline int spread10(int x) {   // 10 bits -> every third bit
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  return (x | (x << 2)) & 0x09249249;
}

// 1. Morton codes: a cooperative grid; each CTA reduces the valid extent of
// its grid-stride rows into parts, and after the grid barrier every CTA
// reduces the parts and writes its rows' codes:
// q = clamp(trunc(((c - lo) / ext) * 1023), 0, 1023) per axis.
__global__ void __launch_bounds__(KEY_THREADS)
bp_sorted_glue_key_kernel(const float* __restrict__ c, int cs,
                          const unsigned char* __restrict__ valid, int Np,
                          float* __restrict__ parts, int* __restrict__ codes) {
  __shared__ float ext_s[4];
  const int t = threadIdx.x;
  const int first = blockIdx.x * blockDim.x, step = gridDim.x * blockDim.x;
  float lo[3], hi[3];
  surtr_bp::valid_extent_rows(c, cs, valid, Np, first, step, lo, hi);
  if (t == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      parts[blockIdx.x * 6 + a] = lo[a];
      parts[blockIdx.x * 6 + 3 + a] = hi[a];
    }
  }
  cg::this_grid().sync();
  if (t < 32) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float mn = INFINITY, mx = -INFINITY;
      for (int b = t; b < (int)gridDim.x; b += 32) {
        mn = fminf(mn, parts[b * 6 + a]);
        mx = fmaxf(mx, parts[b * 6 + 3 + a]);
      }
      lo[a] = surtr_bp::warp_min(mn);
      hi[a] = surtr_bp::warp_max(mx);
    }
    if (t == 0) {
      float ext = fmaxf(fmaxf(hi[0] - lo[0], hi[1] - lo[1]), hi[2] - lo[2]);
      ext_s[0] = lo[0];
      ext_s[1] = lo[1];
      ext_s[2] = lo[2];
      ext_s[3] = ext < 1e-6f ? 1e-6f : ext;      // clamp(min=1e-6)
    }
  }
  __syncthreads();
  const float ext = ext_s[3];
  for (int i = first + t; i < Np; i += step) {
    int code = CODE_INVALID;
    if (valid[i]) {
      int q[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float x = (c[(size_t)i * cs + a] - ext_s[a]) / ext * 1023.0f;
        q[a] = min(max((int)x, 0), 1023);
      }
      code = spread10(q[0]) | (spread10(q[1]) << 1) | (spread10(q[2]) << 2);
    }
    codes[i] = code;
  }
}

// 3. The sorted table: one thread a sorted row.
__global__ void __launch_bounds__(256)
bp_sorted_glue_pack_kernel(const float* __restrict__ c, int cs, const float* __restrict__ lo,
                           int ls, const float* __restrict__ hi, int hs,
                           const void* __restrict__ owner, int owner64,
                           const unsigned char* __restrict__ valid,
                           const int64_t* __restrict__ order, int Np,
                           float4* __restrict__ table) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Np) return;
  const int64_t p = order[r];
  const float own = owner64 ? (float)static_cast<const long long*>(owner)[p]
                            : (float)static_cast<const int*>(owner)[p];
  float4* row = table + (size_t)r * ROW4;
  row[0] = make_float4(c[p * cs], c[p * cs + 1], c[p * cs + 2], own);
  row[1] = make_float4(lo[p * ls], lo[p * ls + 1], lo[p * ls + 2], valid[p] ? 1.0f : 0.0f);
  row[2] = make_float4(hi[p * hs], hi[p * hs + 1], hi[p * hs + 2], __int_as_float((int)p));
}

// 4. Selection: one warp a sorted lane; each thread scores NC candidates
// (NC * 32 >= 2W), its own rows read from the table (L1 serves a CTA's
// overlapping windows).
template <int NC>
__global__ void __launch_bounds__(WARPS * 32)
bp_sorted_sweep_select_kernel(const float4* __restrict__ table, int Np, int K, int W,
                              int* __restrict__ pidx, unsigned short* __restrict__ picks,
                              unsigned* __restrict__ masks) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= Np) return;                              // whole warps
  const float4 m0 = table[(size_t)r * ROW4];
  const float4 m1 = table[(size_t)r * ROW4 + 1];
  const float4 m2 = table[(size_t)r * ROW4 + 2];
  const bool mval = m1.w > 0.5f;
  const int nc = 2 * W;
  unsigned key[NC];
  int cid[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    key[j] = 0u;                                    // no candidate: below every score
    cid[j] = 0;
    const int cc = lane + 32 * j;
    if (cc < nc) {
      const int rk = r + delta_of(cc, W);
      const int rc = min(max(rk, 0), Np - 1);
      const float4 o0 = table[(size_t)rc * ROW4];
      const float4 o1 = table[(size_t)rc * ROW4 + 1];
      const float4 o2 = table[(size_t)rc * ROW4 + 2];
      float score = -BIG;
      const bool ok = rk >= 0 && rk < Np && mval && o1.w > 0.5f && o0.w != m0.w &&
                      m1.x <= o2.x && o1.x <= m2.x && m1.y <= o2.y && o1.y <= m2.y &&
                      m1.z <= o2.z && o1.z <= m2.z;
      if (ok) {
        const float dx = m0.x - o0.x, dy = m0.y - o0.y, dz = m0.z - o0.z;
        float d2 = dx * dx;
        d2 = d2 + dy * dy;
        d2 = d2 + dz * dz;
        score = -d2;
      }
      key[j] = order_key(score);
      cid[j] = __float_as_int(o2.w);
    }
  }
  // This thread's best untaken candidate: the largest key, lowest index.
  unsigned taken = 0u, bk = 0u;
  int bj = 0, bid = 0;
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (key[j] > bk) {
      bk = key[j];
      bj = j;
      bid = cid[j];
    }
  int slot_c = 0, slot_id = 0;
  unsigned slot_key = 0u;
  for (int k = 0; k < K; ++k) {
    const unsigned best = __reduce_max_sync(FULL, bk);
    const unsigned cmin = __reduce_min_sync(FULL, bk == best ? (unsigned)(lane + 32 * bj) : ~0u);
    const int win = (int)(cmin & 31u);
    const int id = __shfl_sync(FULL, bid, win);
    if (lane == k) {
      slot_c = (int)cmin;
      slot_key = best;
      slot_id = id;
    }
    if (lane == win) {
      taken |= 1u << bj;
      bk = 0u;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (!((taken >> j) & 1u) && key[j] > bk) {
          bk = key[j];
          bj = j;
          bid = cid[j];
        }
    }
  }
  const int nw = (nc + 31) >> 5;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j >= nw) break;
    const unsigned word = __ballot_sync(FULL, (taken >> j) & 1u);
    if (lane == j) masks[(size_t)r * nw + j] = word;
  }
  if (lane < K) {
    const int o = __float_as_int(m2.w);
    const bool real = key_float(slot_key) > -BIG * 0.5f;
    pidx[(size_t)o * K + lane] = slot_id;
    picks[(size_t)r * K + lane] = (unsigned short)(slot_c | (real ? 0x8000 : 0));
  }
}

// Candidate cc's key for sorted lane r: the warp selection's test and score.
__device__ __forceinline__ unsigned window_key(const float4* __restrict__ table, int Np, int W,
                                               int r, int cc, float4 m0, float4 m1, float4 m2,
                                               bool mval) {
  const int rk = r + delta_of(cc, W);
  const int rc = min(max(rk, 0), Np - 1);
  const float4 o0 = table[(size_t)rc * ROW4];
  const float4 o1 = table[(size_t)rc * ROW4 + 1];
  const float4 o2 = table[(size_t)rc * ROW4 + 2];
  float score = -BIG;
  const bool ok = rk >= 0 && rk < Np && mval && o1.w > 0.5f && o0.w != m0.w &&
                  m1.x <= o2.x && o1.x <= m2.x && m1.y <= o2.y && o1.y <= m2.y &&
                  m1.z <= o2.z && o1.z <= m2.z;
  if (ok) {
    const float dx = m0.x - o0.x, dy = m0.y - o0.y, dz = m0.z - o0.z;
    float d2 = dx * dx;
    d2 = d2 + dy * dy;
    d2 = d2 + dz * dz;
    score = -d2;
  }
  return order_key(score);
}

// A lane's list entry: its key above, the complement of the lane's
// candidate number j below, so a larger entry is a larger key or, on a tie,
// the lower candidate (the plain version's stable descending order). 0 is
// below every entry: no candidate.
__device__ __forceinline__ unsigned long long list_entry(unsigned key, int j) {
  return ((unsigned long long)key << 32) | (unsigned)~j;
}

// 4'. The list selection, past the warp selection's limits (K > MAXK or
// W > MAXW): one warp a sorted lane; lane t scores its candidates t, t + 32,
// ... once and orders them by entry, descending: NC > 0 all NC in registers
// (NC * 32 >= 2W); NC == 0 its best L = min(K, ceil(2W / 32)) by insertion
// into a column of the warp's region (wb 8-byte words: 32 x L entries, then
// the selection words), in shared memory or, where `gbuf` is given, in that
// device scratch. Each of the K rounds is a warp max of the lane heads' keys
// and a warp min of the candidate index among the maxima; the winning lane
// writes the slot's pick and its mask bit and moves to its next entry: no
// lane rescans. Then the lanes read the picks back for pidx (the ids from
// the table) and write the lane's mask words.
template <int NC, typename PT>
__global__ void __launch_bounds__(WARPS * 32)
bp_sorted_list_select_kernel(const float4* __restrict__ table, int Np, int K, int W, int L,
                             int wb, int* __restrict__ pidx, PT* __restrict__ picks,
                             unsigned* __restrict__ masks, unsigned long long* __restrict__ gbuf) {
  extern __shared__ unsigned long long list_smem[];
  constexpr PT REAL = (PT)1 << (8 * sizeof(PT) - 1);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + wid;
  if (r >= Np) return;                              // whole warps
  unsigned long long* const reg = gbuf ? gbuf + (size_t)r * wb : list_smem + (size_t)wid * wb;
  const int nc = 2 * W, nw = (nc + 31) >> 5;
  unsigned* const sel = reinterpret_cast<unsigned*>(NC > 0 ? reg : reg + 32 * L);
  for (int j = lane; j < nw; j += 32) sel[j] = 0u;
  const float4 m0 = table[(size_t)r * ROW4];
  const float4 m1 = table[(size_t)r * ROW4 + 1];
  const float4 m2 = table[(size_t)r * ROW4 + 2];
  const bool mval = m1.w > 0.5f;
  unsigned long long head, e[NC > 0 ? NC : 1];
  int cnt = 0, h = 0;                               // NC == 0: entries listed, taken
  if constexpr (NC > 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int cc = lane + 32 * j;
      e[j] = cc < nc ? list_entry(window_key(table, Np, W, r, cc, m0, m1, m2, mval), j) : 0ull;
    }
#pragma unroll
    for (int p = 0; p < NC; ++p)                    // odd-even transposition, descending
#pragma unroll
      for (int j = p & 1; j + 1 < NC; j += 2)
        if (e[j] < e[j + 1]) {
          const unsigned long long t = e[j];
          e[j] = e[j + 1];
          e[j + 1] = t;
        }
    head = e[0];
  } else {
    unsigned long long* const col = reg + lane;     // entry i at col[32 * i]
    for (int j = 0; lane + 32 * j < nc; ++j) {
      const unsigned long long v =
          list_entry(window_key(table, Np, W, r, lane + 32 * j, m0, m1, m2, mval), j);
      if (cnt == L && v < col[32 * (L - 1)]) continue;
      int i = cnt < L ? cnt++ : L - 1;
      for (; i > 0 && col[32 * (i - 1)] < v; --i) col[32 * i] = col[32 * (i - 1)];
      col[32 * i] = v;
    }
    head = cnt > 0 ? col[0] : 0ull;
  }
  __syncwarp();
  for (int k = 0; k < K; ++k) {
    const unsigned hk = (unsigned)(head >> 32);
    const unsigned best = __reduce_max_sync(FULL, hk);
    const unsigned cand = (unsigned)lane + 32u * ~(unsigned)head;
    const unsigned cmin = __reduce_min_sync(FULL, hk == best ? cand : ~0u);
    if (lane == (int)(cmin & 31u)) {
      picks[(size_t)r * K + k] = (PT)((PT)cmin | (key_float(best) > -BIG * 0.5f ? REAL : (PT)0));
      atomicOr(&sel[cmin >> 5], 1u << lane);
      if constexpr (NC > 0) {
#pragma unroll
        for (int j = 0; j + 1 < NC; ++j) e[j] = e[j + 1];
        e[NC - 1] = 0ull;
        head = e[0];
      } else {
        ++h;
        head = h < cnt ? reg[lane + 32 * h] : 0ull;
      }
    }
  }
  __syncwarp();
  const int o = __float_as_int(m2.w);
  for (int k = lane; k < K; k += 32) {
    const PT p = picks[(size_t)r * K + k];
    const int rk = r + delta_of((int)(p & (PT)(REAL - 1)), W);
    const int rc = min(max(rk, 0), Np - 1);
    pidx[(size_t)o * K + k] = __float_as_int(table[(size_t)rc * ROW4 + 2].w);
  }
  for (int j = lane; j < nw; j += 32) masks[(size_t)r * nw + j] = sel[j];
}

// 5. The mutual mask: one thread a (sorted lane, slot).
// PT: the picks' type (16 bits while 2W <= 32,767, else 32), its top bit
// the real flag.
template <typename PT>
__global__ void __launch_bounds__(256)
bp_sorted_sweep_mutual_kernel(const float* __restrict__ table, const PT* __restrict__ picks,
                              const unsigned* __restrict__ masks, int Np, int K, int W,
                              unsigned char* __restrict__ pok) {
  constexpr PT REAL = (PT)1 << (8 * sizeof(PT) - 1);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Np * K) return;
  const int r = t / K;
  const int k = t - r * K;
  const PT p = picks[t];
  bool live = false;
  if (p & REAL) {
    const int d = delta_of((int)(p & (PT)(REAL - 1)), W);
    const int back = d > 0 ? W + d - 1 : -d - 1;   // -d in the partner's delta order
    const int nw = (2 * W + 31) >> 5;
    live = (masks[(size_t)(r + d) * nw + (back >> 5)] >> (back & 31)) & 1u;
  }
  const int o = __float_as_int(table[(size_t)r * 12 + 11]);
  pok[(size_t)o * K + k] = live;
}

}  // namespace

// parts: scratch of 6 * MAX_KEY_BLOCKS floats.
extern "C" int surtr_broadphase_sorted_key(const float* c, int cs, const unsigned char* valid,
                                           int Np, float* parts, int* codes, void* stream) {
  static int cap = -1;
  if (cap < 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bp_sorted_glue_key_kernel,
                                                  KEY_THREADS, 0);
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    cap = min(per_sm * sms, MAX_KEY_BLOCKS);
  }
  if (Np < 1) return (int)cudaErrorInvalidValue;
  const int blocks = min((Np + KEY_THREADS - 1) / KEY_THREADS, cap);
  void* args[] = {&c, &cs, &valid, &Np, &parts, &codes};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)bp_sorted_glue_key_kernel,
                                                    dim3(blocks), dim3(KEY_THREADS), args, 0,
                                                    (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int surtr_broadphase_sorted_pack(const float* c, int cs, const float* lo, int ls,
                                            const float* hi, int hs, const void* owner,
                                            int owner64, const unsigned char* valid,
                                            const int64_t* order, int Np, float* table,
                                            void* stream) {
  if (Np < 1) return (int)cudaErrorInvalidValue;
  bp_sorted_glue_pack_kernel<<<(Np + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      c, cs, lo, ls, hi, hs, owner, owner64, valid, order, Np, reinterpret_cast<float4*>(table));
  return (int)cudaGetLastError();
}

namespace {

// 8-byte words of a warp's region in the list selection: with its list in
// memory (W > MAXW) 32 x min(K, ceil(2W / 32)) entries, then the lane's
// ceil(2W / 32) selection words (broadphase_cuda.list_bytes mirrors it).
inline long long list_words(int K, int W, bool listed) {
  const int nw = (2 * W + 31) >> 5;
  return (listed ? 32LL * (K < nw ? K : nw) : 0LL) + (nw + 1) / 2;
}

constexpr int MAX_DEVICES = 64;
constexpr int MAX_SMEM = 232448;    // opt-in dynamic shared memory a block, H100
int list_smem_set[2][MAX_DEVICES] = {};   // <0, u16>, <0, u32>

template <int NC, typename PT>
cudaError_t launch_list(const float4* t4, int Np, int K, int W, int* pidx, void* picks,
                        unsigned* masks, unsigned long long* gbuf, cudaStream_t st) {
  const bool listed = NC == 0;
  const long long wb = list_words(K, W, listed);
  const int L = listed ? (int)min((long long)K, (long long)((2 * W + 31) >> 5)) : 0;
  int wpc = WARPS;
  size_t smem = 0;
  if (gbuf == nullptr) {
    const long long fit = MAX_SMEM / (wb * 8);
    if (fit < 1) return cudaErrorInvalidValue;
    wpc = (int)(fit < WARPS ? fit : WARPS);
    smem = (size_t)(wpc * wb * 8);
  }
  if (listed && smem > 48 * 1024) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    int& set = list_smem_set[sizeof(PT) == 4][dev];
    if ((int)smem > set) {
      const cudaError_t e = cudaFuncSetAttribute(bp_sorted_list_select_kernel<NC, PT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
      if (e != cudaSuccess) return e;
      set = (int)smem;
    }
  }
  bp_sorted_list_select_kernel<NC, PT><<<(Np + wpc - 1) / wpc, 32 * wpc, smem, st>>>(
      t4, Np, K, W, L, (int)wb, pidx, static_cast<PT*>(picks), masks, gbuf);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long surtr_broadphase_sorted_list_bytes(int K, int W) {
  return list_words(K, W, true) * 8;
}

// variant: 0 the warp selection (K <= MAXK, W <= MAXW), 1 the list
// selection (registers up to W = MAXW, shared memory past it), 2 the list
// selection with its lists in `gbuf` (Np * list_bytes(K, W) bytes; W >
// MAXW). picks: (Np, K), 16-bit while 2W <= 32,767, else 32-bit; masks:
// (Np, ceil(2W / 32)) words.
extern "C" int surtr_broadphase_sorted(const float* table, int Np, int K, int W, int variant,
                                       int* pidx, unsigned char* pok, void* picks,
                                       unsigned* masks, void* gbuf, void* stream) {
  if (K < 1 || K > 2 * W || Np < 1 || variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  if (variant == 0 && (K > MAXK || W > MAXW)) return (int)cudaErrorInvalidValue;
  if ((variant == 2) != (gbuf != nullptr) || (variant == 2 && W <= MAXW))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float4* t4 = reinterpret_cast<const float4*>(table);
  const bool wide = 2 * W > 32767;                  // 32-bit picks
  unsigned long long* g = static_cast<unsigned long long*>(gbuf);
  cudaError_t e = cudaSuccess;
  if (variant == 0) {
    const dim3 grid((Np + WARPS - 1) / WARPS), block(WARPS * 32);
    unsigned short* p16 = static_cast<unsigned short*>(picks);
    if (W <= 32)
      bp_sorted_sweep_select_kernel<2><<<grid, block, 0, st>>>(t4, Np, K, W, pidx, p16, masks);
    else
      bp_sorted_sweep_select_kernel<8><<<grid, block, 0, st>>>(t4, Np, K, W, pidx, p16, masks);
    e = cudaGetLastError();
  } else if (W <= 32) {
    e = launch_list<2, unsigned short>(t4, Np, K, W, pidx, picks, masks, nullptr, st);
  } else if (W <= MAXW) {
    e = launch_list<8, unsigned short>(t4, Np, K, W, pidx, picks, masks, nullptr, st);
  } else if (wide) {
    e = launch_list<0, unsigned>(t4, Np, K, W, pidx, picks, masks, g, st);
  } else {
    e = launch_list<0, unsigned short>(t4, Np, K, W, pidx, picks, masks, g, st);
  }
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)Np * K;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (wide)
    bp_sorted_sweep_mutual_kernel<unsigned><<<blocks, 256, 0, st>>>(
        table, static_cast<const unsigned*>(picks), masks, Np, K, W, pok);
  else
    bp_sorted_sweep_mutual_kernel<unsigned short><<<blocks, 256, 0, st>>>(
        table, static_cast<const unsigned short*>(picks), masks, Np, K, W, pok);
  return (int)cudaGetLastError();
}
