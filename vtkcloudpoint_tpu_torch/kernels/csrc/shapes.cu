// Fused per-cluster shape analytics on Hopper (sm_90a): one thread block
// per cluster computes the gift-wrap hull, the minimal enclosing circle
// (MEC) and the min-area rectangle on data held in shared memory.
//
// Replaces: vtkcloudpoint_tpu/ops/pallas/shapes_kernel.py,
//   cluster_shapes_pallas (:273) running _shapes_kernel (:86).
//
// Computes, per cluster row of `cap` slots (points + validity):
//   hull   start at the lowest y, then lowest x; each step takes the valid,
//          unpicked point of least reference pseudo-angle >= the current
//          sweep angle (first index on ties) until the wrap closes or
//          max_hull vertices are taken;
//   MEC    over the hull pairs (i < j, row-major) then the C(h, 3) triples
//          in lexicographic order: the least radius^2 whose circle holds
//          every other valid hull point (d2 <= r2, the candidate's own
//          defining points skipped); first candidate on ties, and a triple
//          wins only on a strictly smaller radius^2; degenerate triples
//          (inf or nan) count as BIG = 1e30;
//   rect   for each hull edge, the extents of the hull projected on the
//          edge direction and its normal; the least area wins (first edge).
//   Arithmetic follows ops/geometry.py term by term (pseudo_angle,
//   _circumcircle, the projections), so the plain version agrees with it.
//
// What bounds it on the H100: the hull's dependent steps. Each of up to
// max_hull - 1 steps is a block-wide (value, first index) argmin over the
// cluster's cap points and needs two barriers, so latency, not bandwidth
// or arithmetic, sets the time; 2048 clusters in flight keep the SMs busy
// while each block waits. The MEC scan (496 pairs + 4960 triples at
// max_hull 32, each checked against <= 32 hull points) is spread over the
// block's threads. Shared memory is ~10 bytes per slot (10 KB at cap 1024),
// so several blocks share an SM.
//
// Build with --fmad=false: containment (d2 <= r2), the angle comparisons
// and the argmins are exact float decisions that a contracted multiply-add
// would move. IEEE division and sqrt are required (no fast math).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float pseudo_angle(float x1, float y1, float x2,
                                              float y2) {
  const float dx = x2 - x1;
  const float dy = y2 - y1;
  const float denom = fabsf(dx) + fabsf(dy);
  float t;
  if (denom == 0.0f) {
    t = 40.0f;  // 360 / 9: identical points
  } else {
    t = dy / denom;
    if (dx < 0.0f)
      t = 2.0f - t;
    else if (dy < 0.0f)
      t = 4.0f + t;
  }
  return t * 90.0f;
}

__device__ __forceinline__ void amin_combine(float& v, int& i, float ov,
                                             int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide (least value, first index); every thread gets the result.
__device__ void block_argmin(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    amin_combine(v, i, __shfl_down_sync(0xffffffffu, v, off),
                 __shfl_down_sync(0xffffffffu, i, off));
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = kThreads / 32;
    v = lane < nw ? sv[lane] : INFINITY;
    i = lane < nw ? si[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1)
      amin_combine(v, i, __shfl_down_sync(0xffffffffu, v, off),
                   __shfl_down_sync(0xffffffffu, i, off));
    if (lane == 0) {
      sv[32] = v;
      si[32] = i;
    }
  }
  __syncthreads();
  v = sv[32];
  i = si[32];
  __syncthreads();
}

__device__ __forceinline__ void pair_circle(const float* px, const float* py,
                                            int a, int b, float& cx,
                                            float& cy, float& r2) {
  cx = (px[a] + px[b]) / 2.0f;
  cy = (py[a] + py[b]) / 2.0f;
  const float ex = cx - px[a];
  const float ey = cy - py[a];
  r2 = ex * ex + ey * ey;
}

__device__ __forceinline__ void circumcircle(const float* px, const float* py,
                                             int a, int b, int c, float& cx,
                                             float& cy, float& r2) {
  const float x1 = (px[b] + px[a]) / 2.0f;
  const float y1 = (py[b] + py[a]) / 2.0f;
  const float dy1 = px[b] - px[a];
  const float dx1 = -(py[b] - py[a]);
  const float x2 = (px[c] + px[b]) / 2.0f;
  const float y2 = (py[c] + py[b]) / 2.0f;
  const float dy2 = px[c] - px[b];
  const float dx2 = -(py[c] - py[b]);
  const float denom = dy1 * dx2 - dx1 * dy2;
  const float t1 = ((x1 - x2) * dy2 + (y2 - y1) * dx2) / denom;
  cx = x1 + dx1 * t1;
  cy = y1 + dy1 * t1;
  const float ex = cx - px[a];
  const float ey = cy - py[a];
  r2 = ex * ex + ey * ey;
}

// Every valid hull point other than the defining slots a, b, c lies in the
// circle.
__device__ __forceinline__ bool encloses(const float* px, const float* py,
                                         int nh, float cx, float cy, float r2,
                                         int a, int b, int c) {
  for (int m = 0; m < nh; ++m) {
    if (m == a || m == b || m == c) continue;
    const float ex = cx - px[m];
    const float ey = cy - py[m];
    const float d2 = ex * ex + ey * ey;
    if (!(d2 <= r2)) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
    shapes_kernel(const float* __restrict__ points,
                  const uint8_t* __restrict__ valid, int cap, int h,
                  const int* __restrict__ pairs, int n_pairs,
                  const int* __restrict__ triples, int n_triples,
                  float* __restrict__ out) {
  extern __shared__ float sm[];
  float* x = sm;
  float* y = x + cap;
  float* hx = y + cap;   // hull vertex coordinates, BIG past the hull
  float* hy = hx + h;
  float* eu = hy + h;    // rectangle extents per hull edge
  float* ev = eu + h;
  uint8_t* vf = (uint8_t*)(ev + h);
  uint8_t* picked = vf + cap;
  __shared__ float red_v[33];
  __shared__ int red_i[33];

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pk = points + (size_t)k * cap * 2;
  const uint8_t* vk = valid + (size_t)k * cap;
  int local_any = 0;
  for (int i = tid; i < cap; i += kThreads) {
    x[i] = pk[2 * i];
    y[i] = pk[2 * i + 1];
    vf[i] = vk[i] != 0;
    picked[i] = 0;
    local_any |= vf[i];
  }
  const bool any_valid = __syncthreads_or(local_any);

  // ---- gift-wrap hull ----
  float v = INFINITY;
  int idx = INT_MAX;
  for (int i = tid; i < cap; i += kThreads)
    amin_combine(v, idx, vf[i] ? y[i] : kBig, i);
  block_argmin(v, idx, red_v, red_i);
  const float ymin = v;
  v = INFINITY;
  idx = INT_MAX;
  for (int i = tid; i < cap; i += kThreads)
    amin_combine(v, idx, (vf[i] && y[i] == ymin) ? x[i] : kBig, i);
  block_argmin(v, idx, red_v, red_i);
  const int start = idx;
  const float xs = x[start];
  const float ys = y[start];
  if (tid == 0) {
    picked[start] = 1;
    hx[0] = xs;
    hy[0] = ys;
  }
  int nh = any_valid ? 1 : 0;
  int cur = start;
  float sweep = 0.0f;
  __syncthreads();
  for (int step = 0; any_valid && step < h - 1; ++step) {
    const float cx = x[cur];
    const float cy = y[cur];
    v = INFINITY;
    idx = INT_MAX;
    for (int i = tid; i < cap; i += kThreads) {
      const float ang = pseudo_angle(cx, cy, x[i], y[i]);
      const bool ok = vf[i] && !picked[i] && ang >= sweep;
      amin_combine(v, idx, ok ? ang : kBig, i);
    }
    block_argmin(v, idx, red_v, red_i);
    const float first_angle = pseudo_angle(cx, cy, xs, ys);
    if ((first_angle >= sweep && v >= first_angle) || v >= kBig) break;
    cur = idx;
    sweep = v;
    if (tid == 0) {
      picked[idx] = 1;
      hx[nh] = x[idx];
      hy[nh] = y[idx];
    }
    ++nh;
    __syncthreads();
  }
  for (int m = tid; m < h; m += kThreads) {
    if (m >= nh) {
      hx[m] = kBig;
      hy[m] = kBig;
    }
  }
  __syncthreads();

  // ---- MEC: pairs, then triples ----
  v = INFINITY;
  idx = INT_MAX;
  for (int p = tid; p < n_pairs; p += kThreads) {
    const int a = pairs[2 * p];
    const int b = pairs[2 * p + 1];
    float val = kBig;
    if (a < nh && b < nh) {
      float cx, cy, r2;
      pair_circle(hx, hy, a, b, cx, cy, r2);
      if (encloses(hx, hy, nh, cx, cy, r2, a, b, b)) val = r2;
    }
    amin_combine(v, idx, val, p);
  }
  block_argmin(v, idx, red_v, red_i);
  const float best_pair = v;
  const int bp = idx;
  v = INFINITY;
  idx = INT_MAX;
  for (int t = tid; t < n_triples; t += kThreads) {
    const int a = triples[3 * t];
    const int b = triples[3 * t + 1];
    const int c = triples[3 * t + 2];
    float val = kBig;
    if (a < nh && b < nh && c < nh) {
      float cx, cy, r2;
      circumcircle(hx, hy, a, b, c, cx, cy, r2);
      if (isfinite(r2) && encloses(hx, hy, nh, cx, cy, r2, a, b, c))
        val = r2;
    }
    amin_combine(v, idx, val, t);
  }
  block_argmin(v, idx, red_v, red_i);
  const float best_trip = v;
  const int bt = idx;

  // ---- min-area rectangle over hull edges ----
  const int last = max(nh - 1, 0);
  v = INFINITY;
  idx = INT_MAX;
  for (int e = tid; e < h; e += kThreads) {
    float area = kBig;
    if (e < nh) {
      const int nxt = (e == last) ? 0 : min(e + 1, last);
      const float ex = hx[nxt] - hx[e];
      const float ey = hy[nxt] - hy[e];
      const float elen = sqrtf(ex * ex + ey * ey);
      const float ux = ex / fmaxf(elen, 1e-30f);
      const float uy = ey / fmaxf(elen, 1e-30f);
      float max_u = -kBig, min_u = kBig, max_v = -kBig, min_v = kBig;
      for (int m = 0; m < nh; ++m) {
        const float pu = hx[m] * ux + hy[m] * uy;
        const float pv = hx[m] * (-uy) + hy[m] * ux;
        max_u = fmaxf(max_u, pu);
        min_u = fminf(min_u, pu);
        max_v = fmaxf(max_v, pv);
        min_v = fminf(min_v, pv);
      }
      eu[e] = max_u - min_u;
      ev[e] = max_v - min_v;
      if (elen > 0.0f) area = eu[e] * ev[e];
    }
    amin_combine(v, idx, area, e);
  }
  block_argmin(v, idx, red_v, red_i);

  if (tid == 0) {
    const bool use_t = best_trip < best_pair;
    const float best_r2 = use_t ? best_trip : best_pair;
    float cx, cy, r2;
    if (use_t)
      circumcircle(hx, hy, triples[3 * bt], triples[3 * bt + 1],
                   triples[3 * bt + 2], cx, cy, r2);
    else
      pair_circle(hx, hy, pairs[2 * bp], pairs[2 * bp + 1], cx, cy, r2);
    const bool none = best_r2 >= kBig;
    float* o = out + (size_t)k * 6;
    o[0] = none ? xs : cx;
    o[1] = none ? ys : cy;
    o[2] = none ? 0.0f : sqrtf(fmaxf(best_r2, 0.0f));
    const bool rect_ok = v < kBig;
    const float l0 = rect_ok ? eu[idx] : 0.0f;
    const float l1 = rect_ok ? ev[idx] : 0.0f;
    o[3] = rect_ok ? fmaxf(l0, l1) : 0.0f;
    o[4] = rect_ok ? fminf(l0, l1) : 0.0f;
    o[5] = rect_ok ? v : 0.0f;
  }
}

}  // namespace

extern "C" int vtkcp_shapes_smem_bytes(int cap, int h) {
  return (int)((size_t)cap * (2 * sizeof(float) + 2) + (size_t)h * 4 *
                                                           sizeof(float));
}

// points f32 [K, cap, 2] contiguous, valid u8 [K, cap]; pairs i32 [P, 2]
// and triples i32 [T, 3] candidate tables over max_hull = h slots; out f32
// [K, 6] = center x, center y, radius, long side, short side, area.
// Returns a cudaError_t.
extern "C" int vtkcp_cluster_shapes(const void* points, const void* valid,
                                    int K, int cap, int h, const void* pairs,
                                    int n_pairs, const void* triples,
                                    int n_triples, void* out, void* stream) {
  if (K <= 0) return cudaSuccess;
  if (cap <= 0 || h <= 0) return cudaErrorInvalidValue;
  const int bytes = vtkcp_shapes_smem_bytes(cap, h);
  cudaError_t err = cudaFuncSetAttribute(
      shapes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  shapes_kernel<<<K, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)points, (const uint8_t*)valid, cap, h,
      (const int*)pairs, n_pairs, (const int*)triples, n_triples,
      (float*)out);
  return cudaGetLastError();
}
