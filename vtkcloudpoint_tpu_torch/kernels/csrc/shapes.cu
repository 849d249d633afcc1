// Fused per-cluster shape analytics on Hopper (sm_90a): one warp per
// cluster computes the gift-wrap hull, the minimal enclosing circle (MEC)
// and the min-area rectangle on data held in shared memory.
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
// What bounds it on the H100: the hull's dependent steps, each an argmin
// over the cluster's points (one IEEE division a point), and, for a hull of
// h vertices, C(h, 3) circumcircles. The bytes (9 a slot) are a floor of
// 5.5 us at K = 2,048, cap = 1,024, but a cluster is a chain of h argmins,
// so the largest clusters set the time unless they get more threads. This
// design:
//   - G warps a cluster (four warps a block, 4 / G clusters), no barrier
//     beyond the group's own: every argmin is a five-step butterfly of
//     (value, index, x, y) shuffles, and for G > 1 one exchange through
//     shared memory and one named barrier. The launch takes G from the
//     clusters an SM gets (auto_group): a cluster is a chain of dependent
//     steps, and K = 2,048 tables at one warp each leave the SMs' issue
//     slots waiting on latency; at K = 24,576 one warp each fills them and
//     a group's barriers only cost. tools/profile_k2.py times each G
//     through diagnostic builds that fix it (VTKCP_K2_GROUP).
//   - the group's first warp loads the cluster and compacts the valid
//     slots once, in slot order (ballot + popc), with 16-byte loads (two
//     points and two flags a lane), kLoadBatch of them issued before the
//     first is used, so a 1,024-slot row takes four round trips to memory,
//     not sixteen; each wrap step scans the n valid points, not the cap
//     slots, and a compacted index orders as its slot, so ties still go to
//     the lowest slot. The load does not overlap the cluster's own
//     shaping: a second cluster's row staged in shared memory (9 KB at cap
//     1,024) would halve the clusters resident an SM at K = 24,576, and
//     the other resident clusters already hide it (PERF.md).
//   - a thread's points lie 32 G apart (G warps); it takes four at a time,
//     written without branches so that their loads, differences and
//     divisions overlap, and keeps its best by a strict `<` (its points
//     come in index order). The winner's coordinates travel with it through
//     the argmin. A picked point's x becomes NaN, written by the one thread
//     that reads that slot: its pseudo-angle is NaN and fails `>= sweep`,
//     as the picked mask does in the plain version.
//   - the MEC enumerates the pairs a < b < nh and the triples a < b < c < nh
//     of the real hull size nh, not of max_hull, and reads no candidate
//     table. Thread t takes every (32 G)-th pair in row-major order and
//     every (32 G)-th triple in lexicographic order from the t-th, so each
//     thread walks its candidates in increasing table order: the same
//     relative order as the Pallas kernel's tables, so "first on ties"
//     picks the same winner.
//   - exact pruning: a candidate's containment is tested only if its r2 is
//     below the thread's best so far (a later candidate with an equal r2
//     cannot win) and, for a triple, below the best pair (only a strictly
//     smaller triple replaces the pair). The comparisons use the kernel's
//     own float values, so the winner is the unpruned scan's
//     (tests/test_torch_shapes.py mirrors the schedule on the CPU).
//     Containment first tests the point that refuted the thread's last
//     candidate.
//
// Build with --fmad=false: containment (d2 <= r2), the angle comparisons
// and the argmins are exact float decisions that a contracted multiply-add
// would move. IEEE division and sqrt are required (no fast math).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // four warps a block
constexpr int kLoadBatch = 4;       // 16-byte loads a lane in flight
constexpr int kMaxHull = 1024;      // candidate keys hold 10 bits an index
constexpr int kMaxSmem = 232448;    // opt-in shared memory a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;

#ifdef VTKCP_K2_PROFILE
// Diagnostic build only (tools/profile_k2.py): per cluster, clock64() at the
// start of its load (slot 0), at the start of its shaping (1) and after
// each phase (2-5: wrap, MEC pairs, MEC triples, rectangle), the hull size
// in slot 6 and the valid count in 7.
constexpr int kProfSlots = 8;
__device__ long long* g_k2_prof;
#define K2_SET(s, v)                       \
  do {                                     \
    if (prof && t == 0) prof[(s)] = (v);   \
  } while (0)
#else
#define K2_SET(s, v) ((void)0)
#endif
#define K2_CLOCK(s) K2_SET(s, clock64())

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

__device__ __forceinline__ bool less(float v, int i, float ov, int oi) {
  return ov < v || (ov == v && oi < i);
}

// (a, b) := the pair `step` places later in row-major order over
// a < b < nh; a >= nh - 1 once past the last pair. Row a holds b = a + 1 ..
// nh - 1, so an overshoot of r past row a lands on b = a + 2 + r of row
// a + 1.
__device__ __forceinline__ void advance_pair(int& a, int& b, int step,
                                             int nh) {
  b += step;
  while (a < nh - 1 && b >= nh) {
    b -= nh - a - 2;
    ++a;
  }
}

// (a, b, c) := the triple `step` places later in lexicographic order over
// a < b < c < nh; a >= nh - 2 once past the last triple. An overshoot of r
// past the run of (a, b) lands on c = b + 2 + r of (a, b + 1), or of
// (a + 1, a + 2) where (a, b + 1) has no c.
__device__ __forceinline__ void advance_triple(int& a, int& b, int& c,
                                               int step, int nh) {
  c += step;
  while (a < nh - 2 && c >= nh) {
    const int r = c - nh;
    if (++b >= nh - 1) {
      ++a;
      b = a + 1;
    }
    c = b + 1 + r;
  }
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

__device__ __forceinline__ bool inside(const float* px, const float* py,
                                       int m, float cx, float cy, float r2) {
  const float ex = cx - px[m];
  const float ey = cy - py[m];
  const float d2 = ex * ex + ey * ey;
  return d2 <= r2;
}

// Every hull point other than the defining slots a, b, c lies in the
// circle. The point that refuted the lane's last candidate (`wit`) is
// tested first, as it likely refutes this one too: a conjunction, so the
// order changes the cost only, never the answer.
__device__ __forceinline__ bool encloses(const float* px, const float* py,
                                         int nh, float cx, float cy, float r2,
                                         int a, int b, int c, int& wit) {
  if (wit != a && wit != b && wit != c &&
      !inside(px, py, wit, cx, cy, r2))
    return false;
  for (int m = 0; m < nh; ++m) {
    if (m == a || m == b || m == c || m == wit) continue;
    if (!inside(px, py, m, cx, cy, r2)) {
      wit = m;
      return false;
    }
  }
  return true;
}

// pseudo_angle(cx, cy, x[j], y[j]) for the four points j = j0 + S u, u < 4,
// written without branches: the same operations as pseudo_angle, with the
// identical-points case dividing by 1 and then replaced, as
// ops/geometry.py writes it. A picked point or the padding (x NaN) gets
// NaN, which is never >= sweep.
template <int S>
__device__ __forceinline__ void angles4(const float* x, const float* y,
                                        int j0, float cx, float cy,
                                        float (&ang)[4], float (&px)[4],
                                        float (&py)[4]) {
  float dx[4], dy[4], den[4], t[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    px[u] = x[j0 + S * u];
    py[u] = y[j0 + S * u];
    dx[u] = px[u] - cx;
    dy[u] = py[u] - cy;
    den[u] = fabsf(dx[u]) + fabsf(dy[u]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    t[u] = dy[u] / (den[u] == 0.0f ? 1.0f : den[u]);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float tu = dx[u] < 0.0f ? 2.0f - t[u]
                            : (dy[u] < 0.0f ? 4.0f + t[u] : t[u]);
    tu = den[u] == 0.0f ? 40.0f : tu;  // 360 / 9: identical points
    ang[u] = tu * 90.0f;
  }
}

// Barrier of the G warps of group g (named barrier 1 + g; a warp alone
// needs none beyond __syncwarp).
template <int G>
__device__ __forceinline__ void group_sync(int g) {
  if (G > 1)
    asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(32 * G) : "memory");
  else
    __syncwarp();
}

// Least (value, index) over a group of G warps, with two payload values of
// the winner; every thread of the group gets the result. G = 1 is a warp
// butterfly; G > 1 adds one exchange through shared memory, double-
// buffered by `phase` so that one group barrier a call suffices.
template <int G>
__device__ __forceinline__ void group_min(float& v, int& i, float& a,
                                          float& b, float4* red, int& phase,
                                          int g) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    const float oa = __shfl_xor_sync(kFull, a, off);
    const float ob = __shfl_xor_sync(kFull, b, off);
    if (less(v, i, ov, oi)) {
      v = ov;
      i = oi;
      a = oa;
      b = ob;
    }
  }
  if (G > 1) {
    float4* slot = red + phase * G;
    phase ^= 1;
    const int wg = (threadIdx.x >> 5) % G;  // warp within the group
    if ((threadIdx.x & 31) == 0)
      slot[wg] = make_float4(v, __int_as_float(i), a, b);
    group_sync<G>(g);
#pragma unroll
    for (int w = 0; w < G; ++w) {
      const float4 c = slot[w];
      const int ci = __float_as_int(c.y);
      if (less(v, i, c.x, ci)) {
        v = c.x;
        i = ci;
        a = c.z;
        b = c.w;
      }
    }
  }
}

// Hull, MEC and rectangle of one cluster whose n valid points lie
// compacted in x, y (NaN from n up to a multiple of 128 G), by a group of
// G warps (thread t of 32 G); x is changed (picked points become NaN).
// x0, y0: slot 0 of the cluster as it is (the start when n = 0). Thread 0
// writes o[0..5].
template <int G>
__device__ void cluster_shape(float* x, float* y, float* hx, float* hy,
                              int n, int h, float x0, float y0, int t, int g,
                              float4* red, float* o, long long* prof) {
  constexpr int S = 32 * G;  // a thread's points lie S apart
  const int npad = (n + 4 * S - 1) / (4 * S) * (4 * S);
  const float nan = __int_as_float(0x7fc00000);
  int phase = 0;
  K2_CLOCK(1);

  // ---- gift-wrap hull ----
  float xs = x0, ys = y0;  // the start vertex
  int nh = 0;
  if (n > 0) {
    // least y, then least x among the least y, then least index
    float v = INFINITY, a = 0.0f, b = 0.0f;
    int i = INT_MAX;
    for (int j = t; j < n; j += S) {
      if (y[j] < v) {
        v = y[j];
        i = j;
      }
    }
    group_min<G>(v, i, a, b, red, phase, g);
    const float ymin = v;
    v = INFINITY;
    i = INT_MAX;
    for (int j = t; j < n; j += S) {
      const float val = y[j] == ymin ? x[j] : kBig;
      if (val < v) {
        v = val;
        i = j;
        a = x[j];
        b = y[j];
      }
    }
    group_min<G>(v, i, a, b, red, phase, g);
    xs = a;
    ys = b;
    if (i % S == t) x[i] = nan;  // picked: only its owner reads it again
    if (t == 0) {
      hx[0] = xs;
      hy[0] = ys;
    }
    nh = 1;
    float cx = xs, cy = ys, sweep = 0.0f;
    for (int step = 0; step < h - 1; ++step) {
      v = INFINITY;
      i = INT_MAX;
      // four points a thread at a time: their loads, differences and
      // divisions are independent chains the scheduler can overlap; a
      // thread's points come in index order, so only a strictly smaller
      // value replaces its best
      for (int j0 = t; j0 < npad; j0 += 4 * S) {
        float ang[4], px[4], py[4];
        angles4<S>(x, y, j0, cx, cy, ang, px, py);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float val = ang[u] >= sweep ? ang[u] : kBig;
          if (val < v) {
            v = val;
            i = j0 + S * u;
            a = px[u];
            b = py[u];
          }
        }
      }
      group_min<G>(v, i, a, b, red, phase, g);
      const float first_angle = pseudo_angle(cx, cy, xs, ys);
      if ((first_angle >= sweep && v >= first_angle) || v >= kBig) break;
      cx = a;
      cy = b;
      if (i % S == t) x[i] = nan;
      if (t == 0) {
        hx[nh] = cx;
        hy[nh] = cy;
      }
      sweep = v;
      ++nh;
    }
  }
  group_sync<G>(g);  // the hull, written by thread 0, is read by all
  K2_CLOCK(2);

  // ---- MEC: pairs, then triples, over the nh hull vertices ----
  float pv = kBig, dummy = 0.0f;
  int pkey = INT_MAX;
  int wit = 0;  // the thread's last refuting hull point
  {
    int a = 0, b = 1;
    for (advance_pair(a, b, t, nh); a < nh - 1; advance_pair(a, b, S, nh)) {
      float cx, cy, r2;
      pair_circle(hx, hy, a, b, cx, cy, r2);
      if (r2 < pv && encloses(hx, hy, nh, cx, cy, r2, a, b, b, wit)) {
        pv = r2;
        pkey = (a << 10) | b;
      }
    }
  }
  group_min<G>(pv, pkey, dummy, dummy, red, phase, g);
  const float best_pair = pv;
  K2_CLOCK(3);
  float tv = kBig;
  int tk = INT_MAX;
  {
    int a = 0, b = 1, c = 2;
    for (advance_triple(a, b, c, t, nh); a < nh - 2;
         advance_triple(a, b, c, S, nh)) {
      float cx, cy, r2;
      circumcircle(hx, hy, a, b, c, cx, cy, r2);
      if (r2 < tv && r2 < best_pair &&
          encloses(hx, hy, nh, cx, cy, r2, a, b, c, wit)) {
        tv = r2;
        tk = (a << 20) | (b << 10) | c;
      }
    }
  }
  group_min<G>(tv, tk, dummy, dummy, red, phase, g);
  const float best_trip = tv;
  K2_CLOCK(4);

  // ---- min-area rectangle over hull edges ----
  const int last = max(nh - 1, 0);
  float av = INFINITY, au = 0.0f, aw = 0.0f;
  int ae = INT_MAX;
  for (int e = t; e < nh; e += S) {
    const int nxt = (e == last) ? 0 : min(e + 1, last);
    const float ex = hx[nxt] - hx[e];
    const float ey = hy[nxt] - hy[e];
    const float elen = sqrtf(ex * ex + ey * ey);
    const float ux = ex / fmaxf(elen, 1e-30f);
    const float uy = ey / fmaxf(elen, 1e-30f);
    float max_u = -kBig, min_u = kBig, max_v = -kBig, min_v = kBig;
    for (int m = 0; m < nh; ++m) {
      const float pu = hx[m] * ux + hy[m] * uy;
      const float pw = hx[m] * (-uy) + hy[m] * ux;
      max_u = fmaxf(max_u, pu);
      min_u = fminf(min_u, pu);
      max_v = fmaxf(max_v, pw);
      min_v = fminf(min_v, pw);
    }
    const float eu = max_u - min_u;
    const float ev = max_v - min_v;
    const float area = elen > 0.0f ? eu * ev : kBig;
    if (area < av) {
      av = area;
      ae = e;
      au = eu;
      aw = ev;
    }
  }
  group_min<G>(av, ae, au, aw, red, phase, g);
  K2_CLOCK(5);
  K2_SET(6, nh);
  K2_SET(7, n);

  if (t == 0) {
    const bool use_t = best_trip < best_pair;
    const float best_r2 = use_t ? best_trip : best_pair;
    const bool none = best_r2 >= kBig;
    float cx = xs, cy = ys, r2;
    if (!none && use_t) {
      circumcircle(hx, hy, tk >> 20, (tk >> 10) & 1023, tk & 1023, cx, cy,
                   r2);
    } else if (!none) {
      pair_circle(hx, hy, pkey >> 10, pkey & 1023, cx, cy, r2);
    }
    o[0] = cx;
    o[1] = cy;
    o[2] = none ? 0.0f : sqrtf(fmaxf(best_r2, 0.0f));
    const bool rect_ok = av < kBig;
    o[3] = rect_ok ? fmaxf(au, aw) : 0.0f;
    o[4] = rect_ok ? fminf(au, aw) : 0.0f;
    o[5] = rect_ok ? av : 0.0f;
  }
}

// A cluster's shared memory, in floats: its points (cap padded to a
// multiple of 128 G for a group of G warps) and the hull.
__host__ __device__ inline int cluster_smem_floats(int cap, int h, int G) {
  const int capp = (cap + 128 * G - 1) / (128 * G) * (128 * G);
  return 2 * capp + 2 * h;
}

// Four warps a block, G warps a cluster, 4 / G clusters a block; the groups
// share nothing but the block. The group's first warp loads and compacts
// the cluster, then the whole group shapes it.
template <int G>
__global__ void __launch_bounds__(kThreads)
    shapes_kernel(const float* __restrict__ points,
                  const uint8_t* __restrict__ valid, int K, int cap, int h,
                  bool vec, float* __restrict__ out) {
  constexpr int C = 4 / G;  // clusters a block
  extern __shared__ __align__(16) float sm[];
  __shared__ float4 red[2 * 4];
  __shared__ int s_n[C];
  __shared__ float s_x0[C], s_y0[C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = warp / G;                   // the group, one a cluster
  const int t = threadIdx.x - g * 32 * G;   // thread within the group
  const int k = blockIdx.x * C + g;
  const int per_cluster = cluster_smem_floats(cap, h, G);
  const int capp = (per_cluster - 2 * h) / 2;
  float* x = sm + (size_t)g * per_cluster;
  float* y = x + capp;  // compacted valid points, in slot order
  float* hx = y + capp;
  const unsigned lt = (1u << lane) - 1u;
  const float nan = __int_as_float(0x7fc00000);
  long long* prof = nullptr;
#ifdef VTKCP_K2_PROFILE
  if (k < K) prof = g_k2_prof + (size_t)k * kProfSlots;
#endif
  if (k >= K) return;  // the whole group: it syncs with no other

  // ---- load and compact the valid slots (the group's first warp) ----
  if (t < 32) {
    K2_CLOCK(0);
    const float* pk = points + (size_t)k * cap * 2;
    const uint8_t* vk = valid + (size_t)k * cap;
    int n = 0;
    if (vec) {  // cap even, rows 16-byte aligned: two slots a lane
      const float4* p4 = reinterpret_cast<const float4*>(pk);
      const uint16_t* v2 = reinterpret_cast<const uint16_t*>(vk);
      for (int s0 = 0; s0 < cap; s0 += 64 * kLoadBatch) {
        float4 p[kLoadBatch];
        unsigned vv[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int s = s0 + 64 * u + 2 * lane;
          p[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          vv[u] = 0u;
          if (s < cap) {
            p[u] = p4[s >> 1];
            vv[u] = v2[s >> 1];
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const bool ok0 = (vv[u] & 0xffu) != 0u;
          const bool ok1 = (vv[u] >> 8) != 0u;
          const unsigned b0 = __ballot_sync(kFull, ok0);
          const unsigned b1 = __ballot_sync(kFull, ok1);
          const int j = n + __popc(b0 & lt) + __popc(b1 & lt);
          if (ok0) {
            x[j] = p[u].x;
            y[j] = p[u].y;
          }
          if (ok1) {
            x[j + ok0] = p[u].z;
            y[j + ok0] = p[u].w;
          }
          n += __popc(b0) + __popc(b1);
        }
      }
    } else {
      for (int s0 = 0; s0 < cap; s0 += 32) {
        const int s = s0 + lane;
        const bool ok = s < cap && vk[s] != 0;
        const unsigned b = __ballot_sync(kFull, ok);
        if (ok) {
          const int j = n + __popc(b & lt);
          x[j] = pk[2 * s];
          y[j] = pk[2 * s + 1];
        }
        n += __popc(b);
      }
    }
    for (int j = n + lane; j < capp; j += 32) {
      x[j] = nan;
      y[j] = nan;
    }
    if (lane == 0) {
      s_n[g] = n;
      s_x0[g] = pk[0];
      s_y0[g] = pk[1];
    }
  }
  group_sync<G>(g);
#ifdef VTKCP_K2_LOAD_ONLY
  // diagnostic builds only (tools/profile_k2.py): the load and compaction
  // alone, the most that overlapping them with the shaping could hide
  if (t == 0) {
    out[(size_t)k * 6] = (float)s_n[g];
    out[(size_t)k * 6 + 1] = x[0] + y[s_n[g] > 0 ? s_n[g] - 1 : 0];
  }
  return;
#endif
  cluster_shape<G>(x, y, hx, hx + h, s_n[g], h, s_x0[g], s_y0[g], t, g,
                   red + 2 * G * g, out + (size_t)k * 6, prof);
}

template <int G>
cudaError_t launch(const float* points, const uint8_t* valid, int K, int cap,
                   int h, float* out, cudaStream_t stream) {
  constexpr int C = 4 / G;
  const int bytes = C * cluster_smem_floats(cap, h, G) * (int)sizeof(float);
  const bool vec = cap % 2 == 0 && (uintptr_t)points % 16 == 0 &&
                   (uintptr_t)valid % 2 == 0;
  auto kernel = shapes_kernel<G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(K + C - 1) / C, kThreads, bytes, stream>>>(points, valid, K, cap,
                                                      h, vec, out);
  return cudaGetLastError();
}

template <int G>
int block_bytes(int cap, int h) {
  return (4 / G) * cluster_smem_floats(cap, h, G) * (int)sizeof(float);
}

// Warps a cluster from the clusters an SM gets: 4 up to 8, 2 up to 32, else
// 1 (and more where the shared memory needs fewer clusters a block). On an
// H100 (132 SMs) the tier-2 and Engine tables (K = 2,048, 15.5 an SM) run
// fastest on 2 and the tier-3 tables (K = 24,576) on 1; tools/profile_k2.py
// times each setting at those shapes and at K = 512.
int auto_group(int K, int cap, int h) {
#ifdef VTKCP_K2_GROUP
  // diagnostic builds only (tools/profile_k2.py): G fixed
  return VTKCP_K2_GROUP;
#endif
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 1;
  const bool fit1 = block_bytes<1>(cap, h) <= kMaxSmem;
  const bool fit2 = block_bytes<2>(cap, h) <= kMaxSmem;
  if (K <= 8LL * sms || !fit2) return 4;
  if (K <= 32LL * sms || !fit1) return 2;
  return 1;
}

}  // namespace

// Shared memory of a block of one cluster (four warps), in bytes: the
// least a launch at (cap, h) needs.
extern "C" int vtkcp_shapes_smem_bytes(int cap, int h) {
  return block_bytes<4>(cap, h);
}

// The warps a cluster that a launch of K clusters takes (auto_group).
extern "C" int vtkcp_shapes_group(int K, int cap, int h) {
  return auto_group(K, cap, h);
}

// points f32 [K, cap, 2] contiguous, valid u8 [K, cap]; max_hull = h <=
// 1,024; out f32 [K, 6] = center x, center y, radius, long side, short
// side, area. Returns a cudaError_t.
extern "C" int vtkcp_cluster_shapes(const void* points, const void* valid,
                                    int K, int cap, int h, void* out,
                                    void* stream) {
  if (K <= 0) return cudaSuccess;
  if (cap <= 0 || h <= 0 || h > kMaxHull) return cudaErrorInvalidValue;
  const float* p = (const float*)points;
  const uint8_t* v = (const uint8_t*)valid;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (auto_group(K, cap, h)) {
    case 1:
      if (block_bytes<1>(cap, h) > kMaxSmem) return cudaErrorInvalidValue;
      return launch<1>(p, v, K, cap, h, o, s);
    case 2:
      if (block_bytes<2>(cap, h) > kMaxSmem) return cudaErrorInvalidValue;
      return launch<2>(p, v, K, cap, h, o, s);
    case 4:
      if (block_bytes<4>(cap, h) > kMaxSmem) return cudaErrorInvalidValue;
      return launch<4>(p, v, K, cap, h, o, s);
    default:
      return cudaErrorInvalidValue;
  }
}

#ifdef VTKCP_K2_PROFILE
// Point the diagnostic build's phase clocks at int64 [K, 8] on the card.
extern "C" int vtkcp_k2_profile_buffer(void* buf) {
  return (int)cudaMemcpyToSymbol(g_k2_prof, &buf, sizeof(buf));
}
#endif
