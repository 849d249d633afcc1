// One ICP iteration on Hopper (sm_90a), after the correspondence search:
// moments, Horn solve, pose update and convergence test in one launch.
//
// Replaces: no Pallas kernel. The JAX package runs this body inside a jitted
// lax.while_loop (vtkcloudpoint_tpu/register/icp.py); the port's eager loop
// spent ~1.7 ms of host time an iteration on ~128 small PyTorch launches
// and four reads of the card around ~15 us of device work. Here the
// iteration's state lives on the card and the host only launches K3 and
// this kernel, reading the done flag once per chunk of iterations.
//
// State (all on the card): pose f32 [13] = R row-major (9), t (3), d (the
// last iteration's summed squared distance, the next test's prev_d, +inf at
// the start); flags i32 [4] = iterations, converged, done, ticket. One
// launch, given K3's (idx, d2) for the moved sources p:
//   - if done is set it returns at once and changes nothing;
//   - sums, in float64 over the float32 inputs, the raw moments of the
//     valid sources: sum w, sum w p, sum w y, sum w p y^T, sum w d2 with
//     y = target[idx]. Each product of two floats is exact in a double, so
//     only the sums round; raw moments in float64 keep their precision
//     ~60 m from the origin, where one float32 pass would cancel;
//   - the last block solves Horn's 4x4 N-matrix (built as
//     ops/se3.py: horn_from_moments builds it) by cyclic Jacobi, turns the
//     top eigenvector into R1, sets t1 = mean_y - R1 mean_p, composes
//     R <- R1 R, t <- R1 t + t1 (as se3.compose, in double, stored as
//     float32), and applies the plain loop's test in float32:
//     converged = |d - prev_d| < tol with d the float32 rounding of
//     sum w d2; iterations += 1; done = converged or iterations reached
//     max_iterations;
//   - while not done, it writes the next p = R source + t, which K3 reads
//     on the next launch.
//
// What bounds it: bytes, N (12 + 4 + 4 + 1) for p, idx, d2 and the valid
// byte, 12 a gathered target row, and N x 12 for source in and p out --
// well under a microsecond at the port's shapes, where a launch takes
// ~14-16 us on an H100: one block's dependent loads and reduction, then
// the serial 4x4 float64 solve in one thread. Both hide under the host's
// launches of the loop (~0.1 ms an iteration). The design is one launch
// with a deterministic two-level reduction: each block sums 2,048 rows in
// a fixed order (strided per thread, then warp shuffles, then warps in
// order) into its partial; the last block to take a ticket (threadfence,
// atomic counter) sums the partials in block order, so repeated runs are
// bit-identical and no float atomic is used. One block covers the port's
// ICP shapes (N <= 2,048).
//
// Build with --fmad=false: p = R source + t then rounds as the plain
// version's separate float32 multiplies and adds.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 2048;
// sw, sp (3), sy (3), spy (9, row-major [p axis][y axis]), sd
constexpr int kMoments = 17;
constexpr int kMaxSweeps = 32;

enum { kIterations = 0, kConverged = 1, kDone = 2, kTicket = 3 };
enum { kT = 9, kD = 12 };

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Cyclic Jacobi on the symmetric 4x4 `a`: on return its diagonal holds the
// eigenvalues and the columns of `v` the eigenvectors. An off-diagonal
// entry below the diagonal's rounding is set to zero, so the sweeps end
// with an exactly diagonal matrix. Every loop over an index is unrolled,
// so a and v stay in registers.
__device__ __forceinline__ void jacobi4(double a[4][4], double v[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = i + 1; j < 4; ++j) off += fabs(a[i][j]);
    if (off == 0.0) break;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int q = p + 1; q < 4; ++q) {
        const double apq = a[p][q];
        if (apq == 0.0) continue;
        const double g = 100.0 * fabs(apq);
        if (fabs(a[p][p]) + g == fabs(a[p][p]) &&
            fabs(a[q][q]) + g == fabs(a[q][q])) {
          a[p][q] = a[q][p] = 0.0;
          continue;
        }
        // tan of the angle that zeroes a[p][q]: the smaller root of
        // t^2 + 2 theta t - 1 = 0 (theta^2 may overflow: then t = 0)
        const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
        double t = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
        if (theta < 0.0) t = -t;
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
#pragma unroll
        for (int k = 0; k < 4; ++k) {          // a <- a J
          const double akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {          // a <- J^T a
          const double apk = a[p][k], aqk = a[q][k];
          a[p][k] = c * apk - s * aqk;
          a[q][k] = s * apk + c * aqk;
        }
        a[p][q] = a[q][p] = 0.0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {          // v <- v J
          const double vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
}

// Horn's solve from the summed moments m (kMoments), then the pose update
// and the convergence test; one thread. Writes the new pose (float32) to
// `pose` and to `out`, and returns whether the loop is done.
__device__ __forceinline__ bool solve_and_update(const double* m, float tol,
                                                 int max_iterations,
                                                 float* pose, int* flags,
                                                 float* out) {
  const double sw = fmax(m[0], 1e-30);
  double mp[3], my[3], c[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mp[a] = m[1 + a] / sw;
    my[a] = m[4 + a] / sw;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) c[a][b] = m[7 + 3 * a + b] / sw - mp[a] * my[b];
  // the N-matrix of horn_from_moments: [[tr, delta], [delta, c + c^T - tr I]]
  const double tr = c[0][0] + c[1][1] + c[2][2];
  const double delta[3] = {c[1][2] - c[2][1], c[2][0] - c[0][2],
                           c[0][1] - c[1][0]};
  double n4[4][4], v[4][4];
  n4[0][0] = tr;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    n4[0][1 + a] = n4[1 + a][0] = delta[a];
#pragma unroll
    for (int b = 0; b < 3; ++b)
      n4[1 + a][1 + b] = c[a][b] + c[b][a] - (a == b ? tr : 0.0);
  }
  jacobi4(n4, v);
  // the top eigenvector, ties to the lowest index (selects, no indexing)
  double best = n4[0][0], w = v[0][0], x = v[1][0], y = v[2][0], z = v[3][0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (n4[i][i] > best) {
      best = n4[i][i];
      w = v[0][i];
      x = v[1][i];
      y = v[2][i];
      z = v[3][i];
    }
  }
  const double norm = sqrt(w * w + x * x + y * y + z * z);
  w /= norm;
  x /= norm;
  y /= norm;
  z /= norm;
  // se3.quat_to_rot's layout
  const double r1[3][3] = {
      {w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)},
      {2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)},
      {2 * (x * z - w * y), 2 * (y * z + w * x),
       w * w - x * x - y * y + z * z}};
  double t1[3], r[3][3], t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    t1[a] = my[a] - ((r1[a][0] * mp[0] + r1[a][1] * mp[1]) + r1[a][2] * mp[2]);
    t[a] = pose[kT + a];
#pragma unroll
    for (int b = 0; b < 3; ++b) r[a][b] = pose[3 * a + b];
  }
  // compose: R <- R1 R, t <- R1 t + t1
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float rab = (float)((r1[a][0] * r[0][b] + r1[a][1] * r[1][b]) +
                                r1[a][2] * r[2][b]);
      pose[3 * a + b] = out[3 * a + b] = rab;
    }
    const float ta = (float)(((r1[a][0] * t[0] + r1[a][1] * t[1]) +
                              r1[a][2] * t[2]) + t1[a]);
    pose[kT + a] = out[kT + a] = ta;
  }
  const float d = (float)m[16];
  const bool converged = fabsf(d - pose[kD]) < tol;
  pose[kD] = d;
  const int it = flags[kIterations] + 1;
  const bool done = converged || it >= max_iterations;
  flags[kIterations] = it;
  flags[kConverged] = converged;
  flags[kDone] = done;
  return done;
}

__global__ void __launch_bounds__(kThreads)
    icp_step_kernel(const float* __restrict__ source,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ target,
                    const int* __restrict__ idx, const float* __restrict__ d2,
                    int n, float tol, int max_iterations, float* p,
                    float* pose, int* flags, double* partials) {
  if (flags[kDone]) return;
  __shared__ double red[kWarps][kMoments];
  __shared__ double tot[kMoments];
  __shared__ float next[12];
  __shared__ int last, done;

  double acc[kMoments];
#pragma unroll
  for (int k = 0; k < kMoments; ++k) acc[k] = 0.0;
  const int lo = blockIdx.x * kRowsPerBlock;
  const int hi = min(n, lo + kRowsPerBlock);
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    if (!valid[i]) continue;
    const double px = p[3 * (size_t)i], py = p[3 * (size_t)i + 1],
                 pz = p[3 * (size_t)i + 2];
    const size_t j = 3 * (size_t)idx[i];
    const double yx = target[j], yy = target[j + 1], yz = target[j + 2];
    acc[0] += 1.0;
    acc[1] += px;
    acc[2] += py;
    acc[3] += pz;
    acc[4] += yx;
    acc[5] += yy;
    acc[6] += yz;
    acc[7] += px * yx;
    acc[8] += px * yy;
    acc[9] += px * yz;
    acc[10] += py * yx;
    acc[11] += py * yy;
    acc[12] += py * yz;
    acc[13] += pz * yx;
    acc[14] += pz * yy;
    acc[15] += pz * yz;
    acc[16] += (double)d2[i];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kMoments; ++k) {
    const double s = warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kMoments) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    partials[blockIdx.x * kMoments + threadIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd((unsigned int*)&flags[kTicket], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: every partial is written and fenced
  if (threadIdx.x < kMoments) {
    double s = 0.0;
    for (int b = 0; b < (int)gridDim.x; ++b)
      s += __ldcg(&partials[b * kMoments + threadIdx.x]);
    tot[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    flags[kTicket] = 0;
    done = solve_and_update(tot, tol, max_iterations, pose, flags, next);
  }
  __syncthreads();
  if (done) return;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float sx = source[3 * (size_t)i], sy = source[3 * (size_t)i + 1],
                sz = source[3 * (size_t)i + 2];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      p[3 * (size_t)i + a] =
          ((next[3 * a] * sx + next[3 * a + 1] * sy) + next[3 * a + 2] * sz) +
          next[kT + a];
  }
}

int blocks_for(int n) {
  return n <= 0 ? 1 : (n + kRowsPerBlock - 1) / kRowsPerBlock;
}

}  // namespace

// Doubles of scratch a launch over n sources needs (one partial a block).
extern "C" int vtkcp_icp_partials(int n) { return blocks_for(n) * kMoments; }

// source f32 [N, 3], valid u8 [N], target f32 [M, 3] (M >= 1 if N >= 1),
// idx i32 [N] and d2 f32 [N] from K3 for the moved sources p f32 [N, 3];
// pose f32 [13] and flags i32 [4] the loop's state (see above); partials
// f64 [vtkcp_icp_partials(N)] scratch. All contiguous. Returns a
// cudaError_t.
extern "C" int vtkcp_icp_step(const void* source, const void* valid,
                              const void* target, const void* idx,
                              const void* d2, int n, float tol,
                              int max_iterations, void* p, void* pose,
                              void* flags, void* partials, void* stream) {
  icp_step_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)source, (const uint8_t*)valid, (const float*)target,
      (const int*)idx, (const float*)d2, n, tol, max_iterations, (float*)p,
      (float*)pose, (int*)flags, (double*)partials);
  return cudaGetLastError();
}
