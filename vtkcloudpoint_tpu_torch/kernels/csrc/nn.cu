// Nearest-neighbour argmin on Hopper (sm_90a): the ICP correspondence
// search.
//
// Replaces: vtkcloudpoint_tpu/ops/pallas/neighbor.py, nn_pallas (:183)
//   running _nn_kernel (:150).
//
// Computes, for each query q in [N, 3], the valid reference r in [M, 3] of
// least squared distance, summed from direct differences in coordinate
// order ((q0-r0)^2 + (q1-r1)^2) + (q2-r2)^2; ties go to the lowest
// reference index (a running minimum updated only on strict <, scanned in
// index order). Invalid references count as BIG = 1e30; with no valid
// reference the answer is (0, BIG). Indices are int32: no 2^24 limit and
// no cap on M.
//
// What bounds it on the H100: at the ICP shape (N = 1024 cluster centres,
// M = 512 truth points) the work is 0.5 M distance evaluations, far below
// a microsecond of arithmetic, so the launch itself dominates. Reference
// tiles go through shared memory (broadcast reads, one tile load per
// block) and each thread owns one query, which also keeps large M
// compute-bound rather than bandwidth-bound.
//
// Build with --fmad=false so the squared distances, and hence the argmin,
// equal the plain PyTorch version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kThreads)
    nn_kernel(const float* __restrict__ query, const float* __restrict__ ref,
              const uint8_t* __restrict__ ref_valid, int n, int m,
              int* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float sx[kThreads];
  __shared__ float sy[kThreads];
  __shared__ float sz[kThreads];
  __shared__ uint8_t sv[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (i < n) {
    qx = query[3 * (size_t)i];
    qy = query[3 * (size_t)i + 1];
    qz = query[3 * (size_t)i + 2];
  }
  float best = kBig;
  int best_i = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int j = base + threadIdx.x;
    if (j < m) {
      sx[threadIdx.x] = ref[3 * (size_t)j];
      sy[threadIdx.x] = ref[3 * (size_t)j + 1];
      sz[threadIdx.x] = ref[3 * (size_t)j + 2];
      sv[threadIdx.x] = ref_valid[j];
    }
    __syncthreads();
    const int len = min(kThreads, m - base);
    for (int l = 0; l < len; ++l) {
      float e = qx - sx[l];
      float d = e * e;
      e = qy - sy[l];
      d = d + e * e;
      e = qz - sz[l];
      d = d + e * e;
      if (!sv[l]) d = kBig;
      if (d < best) {
        best = d;
        best_i = base + l;
      }
    }
    __syncthreads();
  }
  if (i < n) {
    idx_out[i] = best_i;
    d2_out[i] = best;
  }
}

}  // namespace

// query f32 [N, 3], ref f32 [M, 3], ref_valid u8 [M], all contiguous;
// outputs idx i32 [N], d2 f32 [N]. Returns a cudaError_t.
extern "C" int vtkcp_nn_argmin(const void* query, const void* ref,
                               const void* ref_valid, int n, int m,
                               void* idx, void* d2, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int blocks = (n + kThreads - 1) / kThreads;
  nn_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)query, (const float*)ref, (const uint8_t*)ref_valid, n,
      m, (int*)idx, (float*)d2);
  return cudaGetLastError();
}
