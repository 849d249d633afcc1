// Per-block DBSCAN on Hopper (sm_90a): one thread block solves one padded
// point block completely in shared memory.
//
// Replaces: vtkcloudpoint_tpu/ops/pallas/dbscan_kernel.py,
//   dbscan_blocks_pallas (:165) and dbscan_blocks_pallas_batched (:215),
//   both running _one_block (:46). The grouped TPU variant only amortised
//   TPU grid steps; here every block is its own CUDA block.
//
// Computes, per block of `cap` slots with validity mask:
//   adjacency  d(i, j) <= thr for valid i, j, where d is the L1 sum, the
//              signed sum (c_i - c_j summed over coordinates) or the squared
//              L2 distance (thr = eps^2), terms added in coordinate order;
//   core       neighbour count including self >= min_pts;
//   roots      the least index reachable from each core point over core
//              edges (min-label propagation to its unique fixpoint);
//   labels     roots ranked 1..k in index order; a valid non-core point
//              takes the largest id among its adjacent cores, else 0.
//   Bit-equal to cluster.dbscan.dbscan_blocks (the plain version).
//
// What bounds it on the H100: shared memory. The bit-packed adjacency is
// cap * (ceil(cap/32) + 1) words -- 132 KB at cap 1024 -- so one block fits
// per SM and the 489-block bench launch runs in ~4 waves over 132 SMs.
// Distances are computed once (cap^2 compare-adds from shared memory,
// broadcast reads); propagation sweeps then touch only the bit rows of core
// points, so each sweep costs O(cap * cap / 32) word reads plus one read
// per core edge. The row stride is padded by one word so that the 32 rows a
// warp writes or reads fall in 32 different banks.
//
// Propagation is asynchronous and in place, with one pointer jump per
// visit: labels only decrease and always name a core point reachable from
// the owner, so the loop ends at the same fixpoint as the synchronous
// reference sweeps. It runs until a sweep changes nothing (no sweep cap).
//
// Build with --fmad=false: the L2 test sums squares, and a contracted
// multiply-add would move pairs across the eps boundary.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
enum Metric { kL1 = 0, kSignedSum = 1, kL2 = 2 };

// shared-memory layout, in 4-byte words
__host__ __device__ inline size_t smem_words(int cap, int d) {
  const size_t w = (cap + 31) / 32;
  return (size_t)cap * (w + 1)   // adjacency rows, stride w + 1
         + w                     // core bits
         + w                     // root bits
         + (w + 1)               // roots before each word
         + (size_t)d * cap       // coordinates, one plane per axis
         + 2 * (size_t)cap       // labels, core ids
         + ((size_t)cap + 3) / 4;  // validity bytes
}

template <int D, int M>
__device__ __forceinline__ float distance(const float* ci, const float* c,
                                          int cap, int j) {
  float d;
  if (M == kL1) {
    d = fabsf(ci[0] - c[j]);
#pragma unroll
    for (int k = 1; k < D; ++k) d = d + fabsf(ci[k] - c[k * cap + j]);
  } else if (M == kSignedSum) {
    d = ci[0] - c[j];
#pragma unroll
    for (int k = 1; k < D; ++k) d = d + (ci[k] - c[k * cap + j]);
  } else {
    float e = ci[0] - c[j];
    d = e * e;
#pragma unroll
    for (int k = 1; k < D; ++k) {
      e = ci[k] - c[k * cap + j];
      d = d + e * e;
    }
  }
  return d;
}

template <int D, int M>
__global__ void __launch_bounds__(kThreads)
    dbscan_block_kernel(const float* __restrict__ coords,
                        const uint8_t* __restrict__ valid, int cap, float thr,
                        int min_pts, int* __restrict__ label,
                        int* __restrict__ n_clusters,
                        uint8_t* __restrict__ core_out) {
  extern __shared__ uint32_t smem[];
  const int W = (cap + 31) >> 5;
  const int S = W + 1;
  uint32_t* adj = smem;
  uint32_t* corebits = adj + (size_t)cap * S;
  uint32_t* rootbits = corebits + W;
  int* wpref = (int*)(rootbits + W);
  float* c = (float*)(wpref + W + 1);
  int* lab = (int*)(c + (size_t)D * cap);
  int* cid = lab + cap;
  uint8_t* vf = (uint8_t*)(cid + cap);
  __shared__ int changed;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* cb = coords + (size_t)b * cap * D;
  const uint8_t* vb = valid + (size_t)b * cap;

  for (int i = tid; i < cap; i += kThreads) {
#pragma unroll
    for (int k = 0; k < D; ++k) c[k * cap + i] = cb[(size_t)i * D + k];
    vf[i] = vb[i] != 0;
  }
  __syncthreads();

  // 1. adjacency bit rows, neighbour counts (self included), core flags
  for (int base = 0; base < cap; base += kThreads) {
    const int i = base + tid;
    bool is_core = false;
    if (i < cap) {
      uint32_t* row = adj + (size_t)i * S;
      if (vf[i]) {
        float ci[D];
#pragma unroll
        for (int k = 0; k < D; ++k) ci[k] = c[k * cap + i];
        int count = 0;
        for (int w = 0; w < W; ++w) {
          const int j0 = w << 5;
          const int jn = min(32, cap - j0);
          uint32_t bits = 0u;
          for (int l = 0; l < jn; ++l) {
            const int j = j0 + l;
            if (vf[j] && distance<D, M>(ci, c, cap, j) <= thr) bits |= 1u << l;
          }
          row[w] = bits;
          count += __popc(bits);
        }
        is_core = count >= min_pts;
      } else {
        for (int w = 0; w < W; ++w) row[w] = 0u;
      }
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, is_core);
    if (i < cap) {
      if (lane == 0) corebits[i >> 5] = ballot;
      lab[i] = is_core ? i : cap;
      core_out[(size_t)b * cap + i] = is_core;
    }
  }
  __syncthreads();

  // 2. min-label propagation over core edges, to the fixpoint
  volatile int* vlab = lab;
  volatile int* vchanged = &changed;
  while (true) {
    __syncthreads();
    if (tid == 0) *vchanged = 0;
    __syncthreads();
    for (int i = tid; i < cap; i += kThreads) {
      const int cur = vlab[i];
      if (cur == cap) continue;  // not core
      int m = cur;
      const uint32_t* row = adj + (size_t)i * S;
      for (int w = 0; w < W; ++w) {
        uint32_t bits = row[w] & corebits[w];
        while (bits) {
          const int l = __ffs(bits) - 1;
          bits &= bits - 1u;
          m = min(m, vlab[(w << 5) + l]);
        }
      }
      m = min(m, vlab[m]);  // pointer jump
      if (m < cur) {
        vlab[i] = m;
        *vchanged = 1;
      }
    }
    __syncthreads();
    if (!*vchanged) break;
  }

  // 3. rank roots in index order (inclusive prefix count, ids 1..k)
  for (int base = 0; base < cap; base += kThreads) {
    const int i = base + tid;
    const bool root = i < cap && lab[i] == i;
    const uint32_t ballot = __ballot_sync(0xffffffffu, root);
    if (i < cap && lane == 0) rootbits[i >> 5] = ballot;
  }
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int w = 0; w < W; ++w) {
      wpref[w] = s;
      s += __popc(rootbits[w]);
    }
    wpref[W] = s;
    n_clusters[b] = s;
  }
  __syncthreads();
  for (int i = tid; i < cap; i += kThreads) {
    const int r = lab[i];
    int id = 0;
    if (r < cap) {
      const int w = r >> 5;
      const int l = r & 31;
      id = wpref[w] + __popc(rootbits[w] & (0xffffffffu >> (31 - l)));
    }
    cid[i] = id;
  }
  __syncthreads();

  // 4. core -> own id; valid non-core -> max adjacent core id; else 0
  for (int i = tid; i < cap; i += kThreads) {
    int out = cid[i];
    if (out == 0 && vf[i]) {
      const uint32_t* row = adj + (size_t)i * S;
      for (int w = 0; w < W; ++w) {
        uint32_t bits = row[w] & corebits[w];
        while (bits) {
          const int l = __ffs(bits) - 1;
          bits &= bits - 1u;
          out = max(out, cid[(w << 5) + l]);
        }
      }
    }
    label[(size_t)b * cap + i] = out;
  }
}

template <int D, int M>
cudaError_t launch(const float* coords, const uint8_t* valid, int B, int cap,
                   float thr, int min_pts, int* label, int* n_clusters,
                   uint8_t* core, cudaStream_t stream) {
  const size_t bytes = smem_words(cap, D) * 4;
  auto kernel = dbscan_block_kernel<D, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, bytes, stream>>>(coords, valid, cap, thr, min_pts,
                                         label, n_clusters, core);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_metric(int metric, const float* coords,
                          const uint8_t* valid, int B, int cap, float thr,
                          int min_pts, int* label, int* n_clusters,
                          uint8_t* core, cudaStream_t stream) {
  switch (metric) {
    case kL1:
      return launch<D, kL1>(coords, valid, B, cap, thr, min_pts, label,
                            n_clusters, core, stream);
    case kSignedSum:
      return launch<D, kSignedSum>(coords, valid, B, cap, thr, min_pts,
                                   label, n_clusters, core, stream);
    case kL2:
      return launch<D, kL2>(coords, valid, B, cap, thr, min_pts, label,
                            n_clusters, core, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vtkcp_dbscan_smem_bytes(int cap, int d) {
  return (int)(smem_words(cap, d) * 4);
}

// coords f32 [B, cap, D] contiguous, valid u8 [B, cap]; outputs label i32
// [B, cap], n_clusters i32 [B], core u8 [B, cap]. Returns a cudaError_t.
extern "C" int vtkcp_dbscan_blocks(const void* coords, const void* valid,
                                   int B, int cap, int d, int metric,
                                   float thr, int min_pts, void* label,
                                   void* n_clusters, void* core,
                                   void* stream) {
  if (B <= 0 || cap <= 0) return cudaSuccess;
  const float* c = (const float*)coords;
  const uint8_t* v = (const uint8_t*)valid;
  int* l = (int*)label;
  int* n = (int*)n_clusters;
  uint8_t* k = (uint8_t*)core;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 2)
    return launch_metric<2>(metric, c, v, B, cap, thr, min_pts, l, n, k, s);
  if (d == 3)
    return launch_metric<3>(metric, c, v, B, cap, thr, min_pts, l, n, k, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* vtkcp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
