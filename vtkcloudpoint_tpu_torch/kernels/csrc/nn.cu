// Nearest-neighbour argmin on Hopper (sm_90a): the ICP correspondence
// search.
//
// Replaces: vtkcloudpoint_tpu/ops/pallas/neighbor.py, nn_pallas (:183)
//   running _nn_kernel (:150).
//
// Computes, for each query q in [N, 3], the valid reference r in [M, 3] of
// least squared distance, summed from direct differences in coordinate
// order ((q0-r0)^2 + (q1-r1)^2) + (q2-r2)^2; ties go to the lowest
// reference index. Invalid references count as BIG = 1e30; with no valid
// reference the answer is (0, BIG). Indices are int32: no 2^24 limit and
// no cap on M.
//
// What bounds it on the H100: FP32 issue, 8 operations a pair (3 sub, 3
// mul, 2 add) plus the compare and two selects of the running minimum --
// once the card is full: the ICP's shapes have few queries (1,024 to
// 12,288), so a grid over queries alone leaves most of the 132 SMs idle.
// This design:
//   - the grid is query tiles x reference splits, sized by the wrapper to
//     at least 4 blocks an SM where M allows; a split holds at least
//     NN_MIN_SPLIT references (kernels/neighbor.py), one full tile of
//     kThreads;
//   - each thread holds kQ queries in registers, so one shared-memory
//     broadcast of a reference serves kQ pairs; references go through
//     shared memory as float4 tiles, an invalid one with x = BIG, so its
//     squared distance is inf and never wins (no validity test a pair);
//   - inside a split a thread scans in index order and keeps a strict <,
//     so it holds the least index among equal distances; the splits merge
//     by one 64-bit atomicMin a query on the key
//     (float_bits(d2) << 32) | idx. d2 >= +0 and BIG is finite, so the bits
//     order as unsigned integers: the least key is the least d2 and, among
//     equal d2, the least index -- the plain version's rule exactly. A
//     first small kernel fills the keys with (bits(BIG), 0), the answer
//     when no reference is valid, and a last one unpacks them into idx and
//     d2: three launches from one host call, and no tensor op around them
//     (at the ICP's small shapes the host's launches are the time).
//   These agree with the plain version wherever the least valid squared
//   distance is below BIG (coordinates below ~1e15).
//
// Build with --fmad=false so the squared distances, and hence the argmin,
// equal the plain PyTorch version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 2;                       // queries a thread
constexpr int kQueriesPerBlock = kThreads * kQ;
constexpr float kBig = 1e30f;
constexpr int kFillThreads = 256;

__global__ void fill_keys(int n, unsigned long long* __restrict__ keys) {
  const int i = blockIdx.x * kFillThreads + threadIdx.x;
  if (i < n) keys[i] = (unsigned long long)__float_as_uint(kBig) << 32;
}

__global__ void unpack_keys(int n, const unsigned long long* __restrict__ keys,
                            int* __restrict__ idx, float* __restrict__ d2) {
  const int i = blockIdx.x * kFillThreads + threadIdx.x;
  if (i < n) {
    const unsigned long long k = keys[i];
    idx[i] = (int)(unsigned int)(k & 0xffffffffull);
    d2[i] = __uint_as_float((unsigned int)(k >> 32));
  }
}

__global__ void __launch_bounds__(kThreads)
    nn_kernel(const float* __restrict__ query, const float* __restrict__ ref,
              const uint8_t* __restrict__ ref_valid, int n, int m,
              int split_len, unsigned long long* __restrict__ keys) {
  __shared__ float4 tile[kThreads];
  const int q0 = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  const int r0 = blockIdx.y * split_len;
  const int r1 = min(m, r0 + split_len);

  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int best_i[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = q0 + k * kThreads;
    const bool ok = i < n;
    qx[k] = ok ? query[3 * (size_t)i] : 0.0f;
    qy[k] = ok ? query[3 * (size_t)i + 1] : 0.0f;
    qz[k] = ok ? query[3 * (size_t)i + 2] : 0.0f;
    best[k] = kBig;
    best_i[k] = 0;
  }

  for (int base = r0; base < r1; base += kThreads) {
    const int j = base + threadIdx.x;
    if (j < r1) {
      const float x = ref_valid[j] ? ref[3 * (size_t)j] : kBig;
      tile[threadIdx.x] =
          make_float4(x, ref[3 * (size_t)j + 1], ref[3 * (size_t)j + 2], 0.0f);
    }
    __syncthreads();
    const int len = min(kThreads, r1 - base);
    for (int l = 0; l < len; ++l) {
      const float4 r = tile[l];
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        float e = qx[k] - r.x;
        float d = e * e;
        e = qy[k] - r.y;
        d = d + e * e;
        e = qz[k] - r.z;
        d = d + e * e;
        if (d < best[k]) {
          best[k] = d;
          best_i[k] = base + l;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = q0 + k * kThreads;
    if (i < n && best[k] < kBig) {
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(best[k]) << 32) |
          (unsigned int)best_i[k];
      atomicMin(keys + i, key);
    }
  }
}

}  // namespace

extern "C" int vtkcp_nn_queries_per_block() { return kQueriesPerBlock; }

// query f32 [N, 3], ref f32 [M, 3], ref_valid u8 [M], all contiguous;
// outputs idx i32 [N], d2 f32 [N]; keys u64 [N] scratch. The least
// (bits(d2) << 32) | idx over `splits` reference splits of `split_len`.
// Returns a cudaError_t.
extern "C" int vtkcp_nn_argmin(const void* query, const void* ref,
                               const void* ref_valid, int n, int m,
                               int splits, int split_len, void* keys,
                               void* idx, void* d2, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* k = (unsigned long long*)keys;
  const int fill_blocks = (n + kFillThreads - 1) / kFillThreads;
  fill_keys<<<fill_blocks, kFillThreads, 0, s>>>(n, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (m > 0) {
    const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, splits);
    nn_kernel<<<grid, kThreads, 0, s>>>(
        (const float*)query, (const float*)ref, (const uint8_t*)ref_valid, n,
        m, split_len, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  unpack_keys<<<fill_blocks, kFillThreads, 0, s>>>(n, k, (int*)idx,
                                                   (float*)d2);
  return cudaGetLastError();
}
