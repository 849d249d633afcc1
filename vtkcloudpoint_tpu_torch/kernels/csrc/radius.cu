// Radius neighbour count on Hopper (sm_90a): for every point, the number of
// valid points within eps, itself included; 0 on invalid rows.
//
// Replaces: vtkcloudpoint_tpu/ops/pallas/neighbor.py, radius_count_pallas
//   (:86) running _count_kernel (:55).
//
// Metrics, each an explicit branch (the Pallas kernel treats every metric
// but l1_motor as squared L2; this kernel does not copy that):
//   0 l1_motor       sum_k |q_k - r_k|          <= thr, thr = f32(eps)
//   1 signed_sum_xy  sum_k (q_k - r_k)          <= thr, thr = f32(eps)
//   2 l2             sum_k (q_k - r_k)^2        <= thr, thr = f32(eps * eps)
// Terms are summed in coordinate order k = 0, 1, 2 from direct differences;
// for L2 the host squares eps in double and rounds once, as the Pallas
// kernel compares against the Python float eps * eps.
//
// What bounds it on the H100: all N^2 pairs are tested. At N = 500k, D = 2
// that is 2.5e11 pair tests of ~6 instructions each (differences, abs or
// square, sum, compare, predicated add): ~1.5e12 FP32/INT instructions
// against ~3.4e13 issued per second, a floor of ~45 ms. Device memory is
// no limit (each reference tile is read once per block).
//
// Design: one thread per query row keeps its count in an int32 register.
// A block stages tiles of kTile references in shared memory as packed
// vectors (float2 for D = 2, float4 for D = 3), so each pair costs one
// broadcast shared-memory load; all lanes of a warp read the same word.
// An invalid reference, and the ragged tail past N, are stored as NaN
// coordinates: every metric's comparison with NaN is false, so the inner
// loop needs neither a validity load nor a bounds check (this takes the
// place of the TPU kernel's BIG padding).
//
// Build with --fmad=false: the L2 sum must not contract into FMAs, or a
// count at the eps boundary could differ from the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

template <int D>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T load(const float* p) { return p[0]; }
  __device__ static T nan() { return __int_as_float(0x7fc00000); }
  __device__ static float at(const T& v, int) { return v; }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T load(const float* p) { return make_float2(p[0], p[1]); }
  __device__ static T nan() {
    const float n = __int_as_float(0x7fc00000);
    return make_float2(n, n);
  }
  __device__ static float at(const T& v, int k) { return k == 0 ? v.x : v.y; }
};
template <>
struct Vec<3> {
  using T = float4;
  __device__ static T load(const float* p) {
    return make_float4(p[0], p[1], p[2], 0.0f);
  }
  __device__ static T nan() {
    const float n = __int_as_float(0x7fc00000);
    return make_float4(n, n, n, 0.0f);
  }
  __device__ static float at(const T& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : v.z);
  }
};

template <int D, int M>
__device__ __forceinline__ float distance(const float (&q)[D],
                                          const typename Vec<D>::T& r) {
  float d = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float e = q[k] - Vec<D>::at(r, k);
    float term;
    if (M == 0) {
      term = fabsf(e);
    } else if (M == 1) {
      term = e;
    } else {
      term = e * e;
    }
    d = (k == 0) ? term : d + term;
  }
  return d;
}

template <int D, int M>
__global__ void __launch_bounds__(kThreads)
    radius_kernel(const float* __restrict__ coords,
                  const uint8_t* __restrict__ valid, int n, float thr,
                  int* __restrict__ out) {
  using V = Vec<D>;
  __shared__ typename V::T tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float q[D];
#pragma unroll
  for (int k = 0; k < D; ++k) q[k] = 0.0f;
  if (i < n) {
#pragma unroll
    for (int k = 0; k < D; ++k) q[k] = coords[(size_t)D * i + k];
  }
  int count = 0;
  for (int base = 0; base < n; base += kTile) {
    for (int l = threadIdx.x; l < kTile; l += kThreads) {
      const int j = base + l;
      tile[l] = (j < n && valid[j]) ? V::load(coords + (size_t)D * j)
                                    : V::nan();
    }
    __syncthreads();
#pragma unroll 8
    for (int l = 0; l < kTile; ++l) {
      count += distance<D, M>(q, tile[l]) <= thr ? 1 : 0;
    }
    __syncthreads();
  }
  if (i < n) out[i] = valid[i] ? count : 0;
}

template <int D>
cudaError_t launch_metric(int metric, const float* coords,
                          const uint8_t* valid, int n, float thr, int* out,
                          cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  switch (metric) {
    case 0:
      radius_kernel<D, 0><<<blocks, kThreads, 0, stream>>>(coords, valid, n,
                                                           thr, out);
      break;
    case 1:
      radius_kernel<D, 1><<<blocks, kThreads, 0, stream>>>(coords, valid, n,
                                                           thr, out);
      break;
    case 2:
      radius_kernel<D, 2><<<blocks, kThreads, 0, stream>>>(coords, valid, n,
                                                           thr, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// coords f32 [N, D] (D = 1, 2 or 3), valid u8 [N], both contiguous; output
// count i32 [N]. metric: 0 l1_motor, 1 signed_sum_xy, 2 l2 (thr = eps^2).
// Returns a cudaError_t.
extern "C" int vtkcp_radius_count(const void* coords, const void* valid,
                                  int n, int d, int metric, float thr,
                                  void* out, void* stream) {
  if (n <= 0) return cudaSuccess;
  const float* c = (const float*)coords;
  const uint8_t* v = (const uint8_t*)valid;
  int* o = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1:
      return launch_metric<1>(metric, c, v, n, thr, o, s);
    case 2:
      return launch_metric<2>(metric, c, v, n, thr, o, s);
    case 3:
      return launch_metric<3>(metric, c, v, n, thr, o, s);
    default:
      return cudaErrorInvalidValue;
  }
}
