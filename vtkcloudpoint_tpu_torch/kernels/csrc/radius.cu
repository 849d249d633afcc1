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
// What bounds it on the H100: FP32 issue. The least work tests each
// unordered pair once: at N = 500k, D = 2, 1.25e11 pairs of 2 D
// instructions, 14.9 ms at 33.5 T instructions/s. Device memory is no limit
// (N D floats, read from L2 once per block).
//
// Design: each unordered pair is tested once, for every metric.
//   - fl(a - b) = -fl(b - a) exactly, so |.| and e * e give the same value
//     from either side, and the signed sum seen from the column point is
//     exactly the negated sum (the same terms, negated, added in the same
//     order). One distance d(i, j) decides the row (d <= thr) and the column
//     (d <= thr, or -d <= thr, that is -thr <= d, for the signed sum).
//   - a decision is the sign of thr - d (of thr + d for the mirrored one),
//     moved into the tile's word by one funnel shift: rounding never changes
//     the sign of a difference, and an exact zero is +0 (thr is made +0 when
//     eps is -0), so `thr - d >= +0` is `d <= thr` wherever thr is finite
//     and d is not NaN. d is never NaN when every coordinate of both points
//     is finite and below 2^126 in magnitude: a difference is then finite,
//     and a sum of them may overflow to inf but never to NaN.
//     A block whose rows or columns hold a "wild" valid point (a NaN, an
//     infinite or a huge coordinate), or any block when thr is not finite,
//     takes the exact path instead: each decision a compare `d <= thr`
//     (`-thr <= d` mirrored), false on NaN as in the plain version, and a
//     select: ptxas makes it an FSETP and a SEL, two more integer-pipe
//     instructions a pair, 18-60% slower when every block took this path
//     (PERF.md). The block decides once, as it loads.
//   - the N x N triangle is cut into super-tiles of S x S points (S =
//     2,048), one thread block each, J >= I. A block holds its S column
//     points in shared memory as coordinate arrays, with a validity word a
//     32-column tile; each warp takes two 32-row tiles with the row points
//     in registers (lane r, rows 32 R + r and 32 (R + 1) + r) and builds,
//     per 32 x 32 tile, each row's 32 decisions into a word (column points
//     read four at a time as float4 broadcasts, shared by both rows). The
//     word is masked by the row's and the columns' validity, so invalid
//     points and the ragged tail past N count nothing, whatever their
//     coordinates (far sentinels would count for valid points as far). The
//     row count is popc(word); the column counts are popc of the word's
//     warp bit transpose (bits.cuh), added into shared counters.
//   - a diagonal tile (rows and columns the same 32 points) adds only row
//     counts: its word already holds every ordered pair, self included (the
//     self test is made, never assumed: with a negative eps a point does not
//     count itself).
//   - counts leave a block by one global atomicAdd a row and a column (out
//     zeroed first; integer adds, so the result does not depend on their
//     order). Partial counts [N / S, N] summed by a second kernel measured
//     0.7% slower at N = 500,000 (PERF.md).
//
// Build with --fmad=false: the L2 sum must not contract into FMAs, or a
// count at the eps boundary could differ from the plain PyTorch version.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "bits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTiles = 64;          // 32-point tiles a super-tile side
constexpr int kS = 32 * kTiles;     // S = 2,048 points
constexpr unsigned kFull = 0xffffffffu;
constexpr float kWild = 0x1p126f;   // a coordinate at or above is "wild"
enum Metric { kL1 = 0, kSignedSum = 1, kL2 = 2 };

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// d(q, r) with q the row point and r column u of the four in v[k], terms in
// coordinate order
template <int D, int M>
__device__ __forceinline__ float distance(const float (&q)[D],
                                          const float4 (&v)[D], int u) {
  float d = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float e = q[k] - comp(v[k], u);
    float term;
    if (M == kL1) {
      term = fabsf(e);
    } else if (M == kSignedSum) {
      term = e;
    } else {
      term = e * e;
    }
    d = (k == 0) ? term : d + term;
  }
  return d;
}

// word := word << 1 | sign bit of x
__device__ __forceinline__ uint32_t push_sign(uint32_t word, float x) {
  return __funnelshift_l(__float_as_uint(x), word, 1);
}

// word := word << 1 | !(a <= b); true where either is NaN
__device__ __forceinline__ uint32_t push_not_le(uint32_t word, float a,
                                                float b) {
  return (word << 1) | (a <= b ? 0u : 1u);
}

// A valid point with a NaN, infinite or huge coordinate
template <int D>
__device__ __forceinline__ bool wild(const float (&q)[D]) {
  bool w = false;
#pragma unroll
  for (int k = 0; k < D; ++k) w |= !(fabsf(q[k]) < kWild);
  return w;
}

// The words of rows q0 and q1 against the 32 columns of tile C: bit c of
// b0 / b1 says column 32 C + c is NOT within (!(d <= thr)), of m0 / m1
// (signed sum only) that the row is not within of the column (!(-thr <=
// d)). Exact compares; else the sign of thr - d (thr + d) decides, exact
// where d is not NaN and thr is finite. The columns go in from 31 down to 0.
template <int D, int M, bool Exact>
__device__ __forceinline__ void tile_words(const float* col, int C,
                                           const float (&q0)[D],
                                           const float (&q1)[D], float thr,
                                           uint32_t& b0, uint32_t& b1,
                                           uint32_t& m0, uint32_t& m1) {
  b0 = b1 = m0 = m1 = 0u;
#pragma unroll
  for (int c = 28; c >= 0; c -= 4) {
    float4 v[D];
#pragma unroll
    for (int k = 0; k < D; ++k)
      v[k] = *reinterpret_cast<const float4*>(col + k * kS + (C << 5) + c);
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      const float d0 = distance<D, M>(q0, v, u);
      const float d1 = distance<D, M>(q1, v, u);
      if (Exact) {
        b0 = push_not_le(b0, d0, thr);
        b1 = push_not_le(b1, d1, thr);
        if (M == kSignedSum) {
          m0 = push_not_le(m0, -thr, d0);
          m1 = push_not_le(m1, -thr, d1);
        }
      } else {
        b0 = push_sign(b0, thr - d0);
        b1 = push_sign(b1, thr - d1);
        if (M == kSignedSum) {
          m0 = push_sign(m0, thr + d0);
          m1 = push_sign(m1, thr + d1);
        }
      }
    }
  }
}

// Row-tile pair of a warp in a snake order over the warps, so that in a
// diagonal block (row tile R holds 64 - R tiles) every warp gets about the
// same walk.
__device__ __forceinline__ int row_pair(int round, int warp) {
  return round * kWarps + ((round & 1) ? kWarps - 1 - warp : warp);
}

// The super-tile (I, J), J >= I, of block b: row I holds n_s - I blocks.
__device__ __forceinline__ void super_tile(long long b, int n_s, int& I,
                                           int& J) {
  const double m = 2.0 * n_s + 1.0;
  long long i = (long long)((m - sqrt(m * m - 8.0 * (double)b)) / 2.0);
  auto start = [n_s](long long r) { return r * n_s - r * (r - 1) / 2; };
  i = i < 0 ? 0 : (i >= n_s ? n_s - 1 : i);
  while (i > 0 && start(i) > b) --i;
  while (i + 1 < n_s && start(i + 1) <= b) ++i;
  I = (int)i;
  J = (int)(i + (b - start(i)));
}

// The block's 32-row tile pairs, two a warp, against its column tiles:
// row counts into out (into colcnt in a diagonal block, whose rows are its
// columns), column counts into colcnt.
template <int D, int M, bool Exact>
__device__ __forceinline__ void row_pairs(const float* __restrict__ coords,
                                          const uint8_t* __restrict__ valid,
                                          int n, float thr, int row0,
                                          int col0, bool diag,
                                          const float* col,
                                          const uint32_t* colok, int* colcnt,
                                          int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // tiles past N hold no valid point: skipped
  const int w_rows = min(kTiles, (n - row0 + 31) >> 5);
  const int w_cols = min(kTiles, (n - col0 + 31) >> 5);
  const int n_pairs = (w_rows + 1) >> 1;
  for (int round = 0; round * kWarps < n_pairs; ++round) {
    const int P = row_pair(round, warp);
    if (P >= n_pairs) continue;
    const int R0 = 2 * P, R1 = 2 * P + 1;
    const int i0 = row0 + (R0 << 5) + lane;
    const int i1 = i0 + 32;
    const bool in0 = i0 < n, in1 = R1 < w_rows && i1 < n;
    // all ones on a valid row: a word AND this keeps an invalid row empty
    const uint32_t ok0 = (in0 && valid[i0]) ? kFull : 0u;
    const uint32_t ok1 = (in1 && valid[i1]) ? kFull : 0u;
    float q0[D], q1[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      q0[k] = in0 ? coords[(size_t)D * i0 + k] : 0.0f;
      q1[k] = in1 ? coords[(size_t)D * i1 + k] : 0.0f;
    }
    int cnt0 = 0, cnt1 = 0;
    // column tiles C0 .. w_cols - 1, each warp from its own starting tile so
    // that the warps' shared-memory adds meet less
    const int C0 = diag ? R0 : 0;
    const int nt = w_cols - C0;
    int C = C0 + warp % nt;
    for (int t = 0; t < nt; ++t, C = (C + 1 == w_cols) ? C0 : C + 1) {
      uint32_t b0, b1, m0, m1;
      tile_words<D, M, Exact>(col, C, q0, q1, thr, b0, b1, m0, m1);
      const uint32_t cm = colok[C];
      b0 = ~b0 & cm & ok0;  // within, both points valid
      b1 = ~b1 & cm & ok1;
      // in a diagonal block, row tile R1 starts at column tile R1
      const bool use1 = !diag || C >= R1;
      cnt0 += __popc(b0);
      if (use1) cnt1 += __popc(b1);
      const uint32_t c0 = M == kSignedSum ? ~m0 & cm & ok0 : b0;
      const uint32_t c1 = M == kSignedSum ? ~m1 & cm & ok1 : b1;
      const bool tdiag0 = diag && C == R0;
      const bool tdiag1 = diag && C == R1;
      int add = 0;
      if (!tdiag0) add += __popc(vtkcp::transpose32(c0, lane));
      if (use1 && !tdiag1) add += __popc(vtkcp::transpose32(c1, lane));
      if (add) atomicAdd(colcnt + (C << 5) + lane, add);
    }
    // an invalid row's count is 0
    if (cnt0) atomicAdd(diag ? colcnt + (i0 - row0) : out + i0, cnt0);
    if (cnt1) atomicAdd(diag ? colcnt + (i1 - row0) : out + i1, cnt1);
  }
}

template <int D, int M>
__global__ void __launch_bounds__(kThreads)
    radius_kernel(const float* __restrict__ coords,
                  const uint8_t* __restrict__ valid, int n, float thr,
                  int* __restrict__ out) {
  __shared__ __align__(16) float col[D * kS];  // D arrays of S coordinates
  __shared__ int colcnt[kS];                   // column counts
  __shared__ uint32_t colok[kTiles];           // bit c: column 32 C + c valid

  const int n_s = (n + kS - 1) / kS;
  int I, J;
  super_tile(blockIdx.x, n_s, I, J);
  const bool diag = I == J;
  const int row0 = I * kS;
  const int col0 = J * kS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  // a warp loads 32 consecutive columns a round: one tile's validity word;
  // a thread also looks at row point row0 + t for a wild coordinate
  bool any_wild = !(fabsf(thr) < INFINITY);
  for (int t = tid; t < kS; t += kThreads) {
    const int j = col0 + t;
    const bool in = j < n;
    float c[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      c[k] = in ? coords[(size_t)D * j + k] : 0.0f;
      col[k * kS + t] = c[k];
    }
    colcnt[t] = 0;
    const bool ok = in && valid[j];
    const uint32_t okw = __ballot_sync(kFull, ok);
    if (lane == 0) colok[t >> 5] = okw;
    any_wild |= ok && wild<D>(c);
    const int i = row0 + t;
    if (!diag && i < n && valid[i]) {
      float r[D];
#pragma unroll
      for (int k = 0; k < D; ++k) r[k] = coords[(size_t)D * i + k];
      any_wild |= wild<D>(r);
    }
  }
  const bool exact = __syncthreads_or(any_wild);

  if (exact) {
    row_pairs<D, M, true>(coords, valid, n, thr, row0, col0, diag, col,
                          colok, colcnt, out);
  } else {
    row_pairs<D, M, false>(coords, valid, n, thr, row0, col0, diag, col,
                           colok, colcnt, out);
  }
  __syncthreads();
  for (int t = tid; t < kS; t += kThreads) {
    const int j = col0 + t;
    if (j >= n) break;
    if (colcnt[t]) atomicAdd(out + j, colcnt[t]);
  }
}

template <int D, int M>
cudaError_t launch(const float* coords, const uint8_t* valid, int n,
                   float thr, int* out, cudaStream_t stream) {
  const long long n_s = (n + (long long)kS - 1) / kS;
  const long long blocks = n_s * (n_s + 1) / 2;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  radius_kernel<D, M><<<(unsigned)blocks, kThreads, 0, stream>>>(
      coords, valid, n, thr, out);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_metric(int metric, const float* coords,
                          const uint8_t* valid, int n, float thr, int* out,
                          cudaStream_t stream) {
  switch (metric) {
    case kL1:
      return launch<D, kL1>(coords, valid, n, thr, out, stream);
    case kSignedSum:
      return launch<D, kSignedSum>(coords, valid, n, thr, out, stream);
    case kL2:
      return launch<D, kL2>(coords, valid, n, thr, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  thr = thr + 0.0f;  // -0 -> +0: an exact-zero difference is +0
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
