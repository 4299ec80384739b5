// Connected components of triangle soups, one per candidate (kernel B3).
//
// Replaces: surtr_tpu/ops/labels_pallas.py `_labels_kernel` (wrapper
// `tri_soup_components_batch_pallas`). Semantics of the plain
// surtr_tpu_torch/ops/labels.py: corners quantized as rint(x / tol) (round
// half to even, a true division, as jnp.round(corners / tol)); triangles
// adjacent when any corner pair has equal quantized triples; exactly
// `rounds` rounds of min-label relaxation then pointer jumping
// (lab <- min(lab, lab[lab])); label = min triangle index of the component,
// invalid triangles get T.
//
// What bounds it on the card: per candidate the T x T corner test (9 triple
// compares per pair, 37k at T = 64) and 2 * rounds dependent passes, i.e.
// integer compare throughput and barrier latency; the input is 2.3 KB per
// candidate at T = 64. Design: one block per candidate, one thread per
// triangle; the adjacency is built once into shared-memory bitmasks
// (T x T bits = 512 B at T = 64) and every round reads it with one word
// per 32 neighbours, labels stay in shared memory across all rounds.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void labels_kernel(const float* __restrict__ corners,
                              const unsigned char* __restrict__ valid,
                              int* __restrict__ labels_out, int T, int rounds,
                              float tol) {
  extern __shared__ int smem[];
  const int W = (T + 31) / 32;
  int* q = smem;                  // T * 9 quantized corners
  unsigned* adj = reinterpret_cast<unsigned*>(q + T * 9);  // T * W bits
  int* lab = reinterpret_cast<int*>(adj + T * W);          // T
  int* vm = lab + T;                                       // T
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const float* cb = corners + (size_t)b * T * 9;

  for (int j = i; j < T * 9; j += blockDim.x) q[j] = (int)rintf(cb[j] / tol);
  if (i < T) vm[i] = valid[(size_t)b * T + i] != 0;
  __syncthreads();

  if (i < T) {
    const int* qi = q + i * 9;
    for (int w = 0; w < W; ++w) {
      unsigned bits = 0u;
      for (int jj = 0; jj < 32; ++jj) {
        const int j = w * 32 + jj;
        if (j >= T) break;
        bool hit = false;
        if (vm[i] && vm[j]) {
          const int* qj = q + j * 9;
          for (int a = 0; a < 3 && !hit; ++a)
            for (int c = 0; c < 3; ++c)
              if (qi[a * 3] == qj[c * 3] && qi[a * 3 + 1] == qj[c * 3 + 1] &&
                  qi[a * 3 + 2] == qj[c * 3 + 2]) { hit = true; break; }
        }
        bits |= (unsigned)hit << jj;
      }
      adj[i * W + w] = bits;
    }
    lab[i] = vm[i] ? i : T;
  }
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    // Relax: min label over adjacent triangles (all reads before writes).
    int nl = T;
    if (i < T) {
      nl = lab[i];
      for (int w = 0; w < W; ++w) {
        unsigned bits = adj[i * W + w];
        while (bits) {
          const int j = w * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
          nl = min(nl, lab[j]);
        }
      }
    }
    __syncthreads();
    if (i < T) lab[i] = vm[i] ? nl : T;
    __syncthreads();
    // Pointer jump: lab <- min(lab, lab[lab]).
    if (i < T) {
      const int l = lab[i];
      nl = (vm[i] && l < T) ? min(l, lab[l]) : T;
    }
    __syncthreads();
    if (i < T) lab[i] = nl;
    __syncthreads();
  }
  if (i < T) labels_out[(size_t)b * T + i] = vm[i] ? lab[i] : T;
}

size_t smem_bytes(int T) {
  const int W = (T + 31) / 32;
  return (size_t)(T * 9 + T * W + 2 * T) * 4;
}

}  // namespace

extern "C" int surtr_labels(const float* corners, const unsigned char* valid,
                            int* labels, int N, int T, int rounds, float tol,
                            void* stream) {
  if (T < 1 || T > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        labels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((T + 31) / 32) * 32;
  if (N > 0)
    labels_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
        corners, valid, labels, T, rounds, tol);
  return (int)cudaGetLastError();
}
