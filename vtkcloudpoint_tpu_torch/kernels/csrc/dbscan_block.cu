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
//              edges (the unique fixpoint of the min-label propagation);
//   labels     roots ranked 1..k in index order; a valid non-core point
//              takes the largest id among its adjacent cores, else 0.
//   Bit-equal to cluster.dbscan.dbscan_blocks (the plain version).
//
// What bounds it on the H100: FP32 issue in the adjacency (cap^2 pair
// tests, a few instructions each) -- once the roots cost less than it. The
// tier blocks are ~99% core with hundreds of neighbours a point, so a root
// search that visits every core edge (min-label sweeps, or a union per
// edge) costs several times the adjacency (tools/profile_k1.py splits the
// time by phase). This design:
//   - adjacency in 32 x 32 bit tiles, one warp per tile: lane r keeps row
//     r's point in registers and builds its 32-bit word against 32 columns
//     read as float2/float4 broadcasts (constant shifts, no per-bit loop).
//     Invalid and padding slots hold NaN coordinates, so every comparison
//     with them is false and no validity test runs per pair.
//   - l1_motor and l2 are bitwise symmetric (fl(a - b) = -fl(b - a), so
//     |.| and e * e agree): only tiles with J >= I are computed and stored;
//     a 32 x 32 bit transpose (five shuffles) gives the mirrored tile's
//     neighbour counts. That halves the pair tests and the adjacency's
//     shared memory (66 KB at cap 1024), so two blocks fit per SM.
//   - their roots by union-find in shared memory. Every core point is first
//     hooked to its least core neighbour (read from the transposed tiles),
//     which on these blocks leaves a few trees; then, for the core-core
//     bits with j > i, one union per tree that a 32-slot word holds (per
//     bit only past kTrees trees): the larger root is hooked under the
//     smaller by atomicCAS; then every path is compressed. Each tree's root
//     is the least index of a connected component of the core graph -- the
//     unique fixpoint of the reference's min-label propagation
//     (dbscan_kernel.py:91-104) -- so the result is bit-equal and the same
//     whatever order the atomics take.
//   - signed_sum_xy is not symmetric (d(j, i) = -d(i, j)): its fixpoint is
//     directed reachability, which union-find would get wrong. It keeps the
//     full tile set and the in-place propagation sweeps with one pointer
//     jump per visit, until a sweep changes nothing.
//   - border labels: core rows push their id to adjacent non-core points
//     (atomicMax) over the stored tiles, non-core rows pull the largest
//     adjacent core id.
//
// Build with --fmad=false: the L2 test sums squares, and a contracted
// multiply-add would move pairs across the eps boundary.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bits.cuh"

namespace {

using vtkcp::transpose32;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTrees = 4;    // trees recorded per column word after the hook
enum Metric { kL1 = 0, kSignedSum = 1, kL2 = 2 };

#ifdef VTKCP_K1_PROFILE
// Diagnostic build only (tools/profile_k1.py): per block, clock64() at the
// start and after each phase (slots 0-5; slot 6 inside the propagation,
// after the hook), and in slot 7 the number of propagation sweeps
// (signed_sum_xy) or of column words whose core points span several trees
// after the hook.
constexpr int kProfSlots = 8;
__device__ long long* g_k1_prof;
#define K1_MARK(k)                                                        \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0)                                                 \
      g_k1_prof[(size_t)blockIdx.x * kProfSlots + (k)] = clock64();       \
  } while (0)
#define K1_NOTE(n)                                                        \
  do {                                                                    \
    if (threadIdx.x == 0)                                                 \
      g_k1_prof[(size_t)blockIdx.x * kProfSlots + 7] = (n);               \
  } while (0)
#else
#define K1_MARK(k) ((void)0)
#define K1_NOTE(n) ((void)0)
#endif

__host__ __device__ constexpr bool symmetric(int metric) {
  return metric != kSignedSum;
}

// bit tiles stored: the upper triangle J >= I, or all of them
__host__ __device__ inline int n_tiles(int w, bool sym) {
  return sym ? w * (w + 1) / 2 : w * w;
}

__device__ __forceinline__ int tile_index(int I, int J, int w, bool sym) {
  return sym ? I * w - (I * (I - 1)) / 2 + (J - I) : I * w + J;
}

// shared-memory layout, in 4-byte words; W = ceil(cap / 32) words a row
__host__ __device__ inline size_t smem_words(int cap, int d, int metric) {
  const size_t w = (cap + 31) / 32;
  const size_t capp = 32 * w;
  return capp * (d == 2 ? 2 : 4)                            // points
         + (size_t)n_tiles((int)w, symmetric(metric)) * 32  // bit tiles
         + 2 * capp      // parent -> cluster id, count -> border id
         + 4 * w         // valid, core, valid non-core and root bits
         + (w + 1)       // roots before each word
         + w * (2 * kTrees + 1);  // each column word's trees
}

template <int D>
using Point = typename std::conditional<D == 2, float2, float4>::type;

__device__ __forceinline__ float c0(const float2& p) { return p.x; }
__device__ __forceinline__ float c1(const float2& p) { return p.y; }
__device__ __forceinline__ float c2(const float2&) { return 0.0f; }
__device__ __forceinline__ float c0(const float4& p) { return p.x; }
__device__ __forceinline__ float c1(const float4& p) { return p.y; }
__device__ __forceinline__ float c2(const float4& p) { return p.z; }

// d(a, b) with a the row point and b the column point, terms in coordinate
// order
template <int D, int M, typename P>
__device__ __forceinline__ float distance(const P& a, const P& b) {
  float d;
  if (M == kL1) {
    d = fabsf(c0(a) - c0(b)) + fabsf(c1(a) - c1(b));
    if (D == 3) d = d + fabsf(c2(a) - c2(b));
  } else if (M == kSignedSum) {
    d = (c0(a) - c0(b)) + (c1(a) - c1(b));
    if (D == 3) d = d + (c2(a) - c2(b));
  } else {
    float e = c0(a) - c0(b);
    d = e * e;
    e = c1(a) - c1(b);
    d = d + e * e;
    if (D == 3) {
      e = c2(a) - c2(b);
      d = d + e * e;
    }
  }
  return d;
}

// Root of x: parents always have a smaller index, so the walk ends where
// par[cur] == cur. With `halve`, each visited node is pointed at its
// grandparent (an ancestor, so always a valid parent).
template <bool halve>
__device__ __forceinline__ int find_root(volatile int* par, int x) {
  int cur = par[x];
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = par[cur])) {
      if (halve) par[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// Join the trees of a and b, given a's root as last seen (`ra`): the larger
// root is hooked under the smaller one, by a CAS that succeeds only while it
// is still a root. Returns a's root as seen after the join.
__device__ __forceinline__ int unite(int* par, int ra, int b) {
  volatile int* vp = par;
  int rb = find_root<true>(vp, b);
  ra = find_root<true>(vp, ra);
  while (ra != rb) {
    const int lo = min(ra, rb);
    const int hi = max(ra, rb);
    const int old = atomicCAS(par + hi, hi, lo);
    if (old == hi) return lo;
    if (hi == ra) {
      ra = find_root<true>(vp, old);
    } else {
      rb = find_root<true>(vp, old);
    }
  }
  return ra;
}

// Every core point's parent := its root (par[i] < cap marks a core point).
// No hook runs meanwhile, so a read-only walk ends at the final root; a walk
// that also wrote could put an ancestor back over a root that another
// thread has just written.
__device__ __forceinline__ void compress(int* par, int cap, int capp,
                                         int tid) {
  for (int i = tid; i < capp; i += kThreads) {
    if (par[i] < cap) {
      const int r = find_root<false>(par, i);
      par[i] = r;
    }
  }
}

// Row groups of 32 rows in a snake order over the warps: the triangle's
// row group I holds W - I words, and every warp gets about the same walk.
__device__ __forceinline__ int row_group(int round, int warp) {
  return round * kWarps + ((round & 1) ? kWarps - 1 - warp : warp);
}

template <int D, int M>
__global__ void __launch_bounds__(kThreads, 2)
    dbscan_block_kernel(const float* __restrict__ coords,
                        const uint8_t* __restrict__ valid, int cap, float thr,
                        int min_pts, int* __restrict__ label,
                        int* __restrict__ n_clusters,
                        uint8_t* __restrict__ core_out) {
  constexpr bool kSym = symmetric(M);
  using P = Point<D>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int W = (cap + 31) >> 5;
  const int capp = W << 5;
  P* pts = reinterpret_cast<P*>(smem);
  uint32_t* tiles = smem + (size_t)capp * (sizeof(P) / 4);
  int* par = (int*)(tiles + (size_t)n_tiles(W, kSym) * 32);
  int* aux = par + capp;
  uint32_t* validbits = (uint32_t*)(aux + capp);
  uint32_t* corebits = validbits + W;
  uint32_t* ncbits = corebits + W;
  uint32_t* rootbits = ncbits + W;
  int* wpref = (int*)(rootbits + W);
  int* wroot = wpref + W + 1;
  uint32_t* wmask = (uint32_t*)(wroot + W * kTrees);
  uint32_t* wrest = wmask + W * kTrees;
  __shared__ int changed;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* cb = coords + (size_t)b * cap * D;
  const uint8_t* vb = valid + (size_t)b * cap;
  K1_MARK(0);

  // 0. points into shared memory; an invalid or padding slot is NaN, so
  //    every distance to it compares false
  const float nan = __int_as_float(0x7fc00000);
  for (int i = tid; i < capp; i += kThreads) {
    const bool ok = i < cap && vb[i] != 0;
    float c[3] = {nan, nan, nan};
    if (ok) {
#pragma unroll
      for (int k = 0; k < D; ++k) c[k] = cb[(size_t)i * D + k];
    }
    if constexpr (D == 2) {
      pts[i] = make_float2(c[0], c[1]);
    } else {
      pts[i] = make_float4(c[0], c[1], c[2], 0.0f);
    }
    aux[i] = 0;
    const uint32_t ballot = __ballot_sync(kFull, ok);
    if (lane == 0) validbits[i >> 5] = ballot;
  }
  __syncthreads();
  K1_MARK(1);

  // 1. adjacency: one warp per 32 x 32 tile (I, J); lane r builds the word
  //    of row 32 I + r over columns 32 J .. 32 J + 31, and the neighbour
  //    counts (self included) add up in aux
  //    The stored tiles go round-robin over the warps in index order: row
  //    I of the tile grid holds J = I .. W - 1 (triangle) or 0 .. W - 1.
  for (int I = 0, J = warp;; J += kWarps) {
    while (I < W && J >= W) {
      J -= W - (kSym ? I + 1 : 0);
      ++I;
    }
    if (I >= W) break;
    const P pi = pts[(I << 5) + lane];
    const P* pj = pts + (J << 5);
    uint32_t bits = 0u;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      if (distance<D, M>(pi, pj[c]) <= thr) bits |= 1u << c;
    }
    tiles[(size_t)tile_index(I, J, W, kSym) * 32 + lane] = bits;
    atomicAdd(aux + (I << 5) + lane, __popc(bits));
    if (kSym && J != I) {
      atomicAdd(aux + (J << 5) + lane, __popc(transpose32(bits, lane)));
    }
  }
  __syncthreads();

  // core flags; parent = self for a core point, capp for the others
  for (int i = tid; i < capp; i += kThreads) {
    const bool v = (validbits[i >> 5] >> (i & 31)) & 1u;
    const bool is_core = v && aux[i] >= min_pts;
    const uint32_t core_word = __ballot_sync(kFull, is_core);
    const uint32_t nc_word = __ballot_sync(kFull, v && !is_core);
    if (lane == 0) {
      corebits[i >> 5] = core_word;
      ncbits[i >> 5] = nc_word;
    }
    par[i] = is_core ? i : capp;
    aux[i] = 0;
    if (i < cap) core_out[(size_t)b * cap + i] = is_core;
  }
  __syncthreads();
  K1_MARK(2);

  // 2. roots of the core graph
  if constexpr (kSym) {
    // (a) hook every core point to its least core neighbour (itself
    //     included): lane c of the warp on column group J reads the
    //     transposed tiles (I, J), I = 0, 1, .., and stops at the first
    //     core bit. These links are edges of the core graph and point to
    //     smaller indices, so they form a forest.
    for (int round = 0; round * kWarps < W; ++round) {
      const int J = row_group(round, warp);
      if (J >= W) continue;
      const bool core_j = (corebits[J] >> lane) & 1u;
      int least = capp;
      for (int I = 0; I <= J && __any_sync(kFull, core_j && least == capp);
           ++I) {
        const uint32_t word =
            tiles[(size_t)tile_index(I, J, W, true) * 32 + lane];
        const uint32_t col = transpose32(
            ((corebits[I] >> lane) & 1u) ? word : 0u, lane);
        if (least == capp && col) least = (I << 5) + __ffs(col) - 1;
      }
      if (core_j) par[(J << 5) + lane] = min(least, (J << 5) + lane);
    }
    __syncthreads();
    compress(par, cap, capp, tid);
    __syncthreads();
    // (b) the trees of each column word J: up to kTrees (root, mask of
    //     the word's core points in that tree) pairs, and the mask of the
    //     core points in further trees
    for (int round = 0; round * kWarps < W; ++round) {
      const int J = row_group(round, warp);
      if (J >= W) continue;
      const bool core_j = (corebits[J] >> lane) & 1u;
      const int r = par[(J << 5) + lane];
      uint32_t rest = __ballot_sync(kFull, core_j);
      for (int k = 0; k < kTrees; ++k) {
        const int first = __shfl_sync(kFull, r, rest ? __ffs(rest) - 1 : 0);
        const uint32_t m = rest ? __ballot_sync(kFull, core_j && r == first)
                                : 0u;
        if (lane == 0) {
          wroot[J * kTrees + k] = m ? first : -1;
          wmask[J * kTrees + k] = m;
        }
        rest &= ~m;
      }
      if (lane == 0) wrest[J] = rest;
    }
    __syncthreads();
    K1_MARK(6);
#ifdef VTKCP_K1_PROFILE
    if (tid == 0) {
      int mixed = 0;
      for (int J = 0; J < W; ++J) mixed += wmask[J * kTrees + 1] != 0u;
      K1_NOTE(mixed);
    }
#endif
    // (c) union-find over the core-core bits with j > i; lane r owns row
    //     32 I + r. A word's bits in one tree need one union with that
    //     tree's root, none where it is row i's own tree; bits in further
    //     trees are united one by one. The larger root is hooked under the
    //     smaller by CAS.
    for (int round = 0; round * kWarps < W; ++round) {
      const int I = row_group(round, warp);
      if (I >= W || !((corebits[I] >> lane) & 1u)) continue;
      const int tree = par[(I << 5) + lane];
      int root = tree;
      for (int J = I; J < W; ++J) {
        uint32_t bits =
            tiles[(size_t)tile_index(I, J, W, true) * 32 + lane] &
            corebits[J];
        if (J == I) bits &= ~((2u << lane) - 1u);
        if (!bits) continue;
#pragma unroll
        for (int k = 0; k < kTrees; ++k) {
          const int other = wroot[J * kTrees + k];
          if ((bits & wmask[J * kTrees + k]) && other != tree)
            root = unite(par, root, other);
        }
        bits &= wrest[J];
        while (bits) {
          const int c = __ffs(bits) - 1;
          bits &= bits - 1u;
          root = unite(par, root, (J << 5) + c);
        }
      }
    }
    __syncthreads();
    compress(par, cap, capp, tid);
  } else {
    // min-label propagation, in place, to the fixpoint
    volatile int* vlab = par;
    volatile int* vchanged = &changed;
    int sweeps = 0;
    while (true) {
      ++sweeps;
      __syncthreads();
      if (tid == 0) *vchanged = 0;
      __syncthreads();
      for (int i = tid; i < capp; i += kThreads) {
        const int cur = vlab[i];
        if (cur >= cap) continue;  // not core
        const int I = i >> 5;
        const int r = i & 31;
        int m = cur;
        for (int J = 0; J < W; ++J) {
          uint32_t bits =
              tiles[(size_t)tile_index(I, J, W, false) * 32 + r] &
              corebits[J];
          while (bits) {
            const int l = __ffs(bits) - 1;
            bits &= bits - 1u;
            m = min(m, vlab[(J << 5) + l]);
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
    K1_NOTE(sweeps);
  }
  __syncthreads();
  K1_MARK(3);

  // 3. rank roots in index order (inclusive prefix count, ids 1..k); the
  //    cluster id replaces the parent in par
  for (int i = tid; i < capp; i += kThreads) {
    const uint32_t ballot = __ballot_sync(kFull, par[i] == i);
    if (lane == 0) rootbits[i >> 5] = ballot;
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
  for (int i = tid; i < capp; i += kThreads) {
    const int r = par[i];
    int id = 0;
    if (r < cap) {
      const int w = r >> 5;
      const int l = r & 31;
      id = wpref[w] + __popc(rootbits[w] & (0xffffffffu >> (31 - l)));
    }
    par[i] = id;
  }
  __syncthreads();
  K1_MARK(4);

  // 4. border: a valid non-core point takes the largest adjacent core id.
  //    Non-core rows pull over their stored words; with the triangle, core
  //    rows also push their id to the non-core columns of tiles J > I.
  for (int round = 0; round * kWarps < W; ++round) {
    const int I = row_group(round, warp);
    if (I >= W) continue;
    const int i = (I << 5) + lane;
    const bool pull = (ncbits[I] >> lane) & 1u;
    const bool push = kSym && ((corebits[I] >> lane) & 1u);
    if (!pull && !push) continue;
    const int id = par[i];
    int best = 0;
    for (int J = kSym ? I : 0; J < W; ++J) {
      const uint32_t u = tiles[(size_t)tile_index(I, J, W, kSym) * 32 + lane];
      if (pull) {
        uint32_t bits = u & corebits[J];
        while (bits) {
          const int c = __ffs(bits) - 1;
          bits &= bits - 1u;
          best = max(best, par[(J << 5) + c]);
        }
      }
      if (push && J != I) {
        uint32_t bits = u & ncbits[J];
        while (bits) {
          const int c = __ffs(bits) - 1;
          bits &= bits - 1u;
          atomicMax(aux + (J << 5) + c, id);
        }
      }
    }
    if (pull) atomicMax(aux + i, best);
  }
  __syncthreads();
  for (int i = tid; i < cap; i += kThreads) {
    const bool is_core = (corebits[i >> 5] >> (i & 31)) & 1u;
    label[(size_t)b * cap + i] = is_core ? par[i] : aux[i];
  }
  K1_MARK(5);
}

template <int D, int M>
cudaError_t launch(const float* coords, const uint8_t* valid, int B, int cap,
                   float thr, int min_pts, int* label, int* n_clusters,
                   uint8_t* core, cudaStream_t stream) {
  const size_t bytes = smem_words(cap, D, M) * 4;
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

extern "C" int vtkcp_dbscan_smem_bytes(int cap, int d, int metric) {
  return (int)(smem_words(cap, d, metric) * 4);
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

#ifdef VTKCP_K1_PROFILE
// Point the diagnostic build's phase clocks at int64 [B, 8] on the card.
extern "C" int vtkcp_k1_profile_buffer(void* buf) {
  return (int)cudaMemcpyToSymbol(g_k1_prof, &buf, sizeof(buf));
}
#endif

extern "C" const char* vtkcp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
