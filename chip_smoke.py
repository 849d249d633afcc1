"""Smoke run of the PyTorch/CUDA port (vtkcloudpoint_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit);
2. builds the hand-written kernels from kernels/csrc/ (nvcc, sm_90a);
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the tier-2 job below (K1 launched twice: its union-find's
   atomics must not change the result), times both with CUDA events, and
   gives each kernel its bound (bytes over the HBM rate, or FP32
   instructions counted from these inputs over the FP32 issue rate), and
   for K3 the time of torch.cdist + min, the nearest library composition
   (never called by the port); K2 also at max_hull 64 on the same tables;
   K5, the ICP step, step by step from icp's start against
   icp_step_plain (it replaces no library call: library_ms null);
4. runs the tier-2 job of bench.py -- the 500,000-point cloud through
   cluster_scan (Morton partition, per-block DBSCAN, fusion with the noise
   re-cluster, centroids, per-cluster tables, hull + MEC + rectangle in two
   coordinate systems), then ICP of the cluster centres onto the truth
   points -- through the kernels, and checks that every kernel launched,
   that nothing overflowed, that the labels equal the same job run with the
   plain versions on the card, and that n_clusters and the label digest
   equal the JAX package's float32 CPU result (tools/jax_reference.py);
5. prints per-stage times;
6. holds K4, the radius count, against its plain version on the card --
   l1_motor on the 500k cloud's motor coordinates, per block against K1's
   core flags, l2_xyz and signed_sum_xy on the Engine session's XYZ --
   through its own entry point (kernels.neighbor.radius_count), launched
   twice (its atomics must not change the counts), and times its
   yardstick, (torch.cdist(q, ref, p=1) <= eps).sum(1) in chunks;
7. runs the Engine session of tools/engine_session.py (500k points:
   import, distance filter, cluster with max_hull 64, radius rejection,
   registration single-start, multi-start and RANSAC, match, export)
   through the kernels and again with the plain versions on the card, holds
   the two runs equal and the single-start run to the JAX package's float32
   CPU result (tools/jax_reference_engine.py), and holds K2 at h = 64
   against its plain version at the session's shapes;
8. runs the tier-3 job of benchmarks/tier3_scale.py at full width (5M
   points, 4,883 blocks, the 65,536-slot noise re-cluster on the grid
   engine, 24,576 shape tables, ICP at N = 12,288, M = 5,120) through the
   kernels and with the plain versions on the card, holds K1-K3 and K5
   against their plain versions at its shapes, checks the labels, overflow counters
   and ICP against the JAX package's float32 CPU result
   (tools/jax_reference_tier3.py), and times the noise stage on the grid
   engine against dense_chunked;
9. runs Engine.cluster_grid on the Engine session at cell_cap 2048 (exact
   global DBSCAN), grid ICP against brute-force ICP through K3 at 100,000
   points and, in float64, against the JAX package's float64 run, the halo
   union on the tier-2 cloud, and the shape variants
   (quickhull, Elzinga-Hearn MEC, candidate pruning) at K2's tier-2 shapes,
   each checked against the JAX CPU constants or K2;
10. runs the tier-4 SLAM job of benchmarks/tier4_slam.py at full size (100
   scans of 2,048 points: ICP odometry, loop closures, pose-graph GN,
   cluster-centroid BA) and scan-to-map on its scans, through the kernels
   and with the plain versions on the card (equal bit for bit), and in
   float64 against the JAX package's float64 CPU run
   (tools/jax_reference_tier4.py); holds K3 and K5 against their plain
   versions at N = M = 2,048;
11. runs the multi-device paths (parallel/) on a one-rank NCCL process
   group (world size 1: NCCL refuses two ranks on one card, so the
   multi-rank semantics are held on the CPU by tests/test_torch_sharded.py
   over gloo): (a) sharded_blocked_dbscan on the tier-3 blocks, whose
   labels equal the tier-3 job's; (b) Engine.cluster_sharded on the Engine
   session in the modes of tools/sharded_session.py, equal to the port's
   single-device halo chain and to the JAX package's float32 CPU run
   (tools/jax_reference_sharded.py); (c) sharded_icp at tier 3's
   registration; (d) sharded_icp_grid at grid ICP's size, grid and brute
   (K3) locators; (e) slam_pipeline_ba(mesh=...) on the tier-4 scans; K1
   and K3 must launch on these paths;
12. prints a JSON line describing every kernel, and last
   {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA device it exits with 1 at once. It imports
nothing of JAX and nothing of the JAX package (it checks both at the end):
the port keeps its own copies of the numpy-only modules (config,
io/loaders, viz).
"""
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# The JAX package's answer for this job in float32 on the CPU (jnp path),
# from `JAX_PLATFORMS=cpu python3 tools/jax_reference.py`.
JAX_N_CLUSTERS = 988
JAX_LABEL_SHA256 = (
    "341095c70962786c47a3b6c112da866e585a24ff03c3e16189b4003aac4937db")
JAX_ICP_T = (-2.230146128567867e-05, -3.541275145835243e-05, 0.0)
JAX_ICP_ERROR = 0.0015145540237426758
# n_clusters of the TPU bench record BENCH_r05.json: information only
TPU_RECORD_N_CLUSTERS = 988
# The JAX package's Engine on the session of tools/engine_session.py, in
# float32 on the CPU, from `JAX_PLATFORMS=cpu python3
# tools/jax_reference_engine.py` (single-start registration).
JAX_ENGINE = dict(
    n_clusters=991,
    label_sha256=(
        "05a2a358930a8dabeb5a8b64bc62c0e6948bc4e828469dd1a34e72605f815ce5"),
    n_rejected=139,
    n_matched=991,
    icp_r=((1.0, -0.00012750193127430975, 0.0),
           (0.00012750193127430975, 1.0, 0.0), (0.0, 0.0, 1.0)),
    icp_t=(0.0004225076118018478, -0.0007517647463828325, 0.0),
)

# The JAX package's answers for the tier-3 phases in float32 on the CPU,
# from `JAX_PLATFORMS=cpu python3 tools/jax_reference_tier3.py` (jax 0.9.0).
# (a) the 5M-point tier-3 job; ICP R, t and iterations of its Pallas NN
# (direct differences, the port's semantics), the error of its jnp path.
JAX_TIER3 = dict(
    n_clusters=10460,
    label_sha256=(
        "d9f3550bb19924834e533e3635532e2da481a2f665f866504d5bf423c8a89f0b"),
    noise_overflow=0, gather_overflow=0, bucket_overflow=0,
    icp_iterations=5,
    icp_r=((1.0, -3.813039802480489e-05, -1.324123810597655e-09),
           (3.813039802480489e-05, 1.0, -1.3593067643702383e-11),
           (1.3241243657091673e-09, 1.3542579384295816e-11, 1.0)),
    icp_t=(3.253547038184479e-05, -2.449486828481895e-06,
           -5.556017072198133e-14),
    icp_error_jnp=0.14654541015625,
)
# n_clusters of the TPU v5e record TIER3_r05.json (dense_chunked noise
# engine): information only
TPU_RECORD_TIER3_N_CLUSTERS = 10463
# (b) Engine.cluster_grid on the Engine session, cell_cap 2048
JAX_GRID_ENGINE = dict(
    n_clusters=419,
    label_sha256=(
        "2110ab6888bfebdd745e8c35f8755b22405b66871f5602b761f5a24fd39c9124"),
    overflow=0, n_core=496888,
    count_sha256=(
        "66f3aead879391ba619aeef6b579a241b84136495fb9d2dba5884e7bf8a9b108"),
    n_nonempty=419, n_filtered=499243)
# (c) icp_grid on tools/tier3_inputs.nn_inputs (m = 100,000)
JAX_ICP_GRID = dict(
    icp_r=((0.999817430973053, -0.01922808401286602,
            -0.00034359964774921536),
           (0.019228260964155197, 0.999817430973053, 0.000514439248945564),
           (0.0003336444206070155, -0.0005209511728025973,
            1.0000026226043701)),
    icp_t=(-1.1933776140213013, 1.3152999877929688, 0.10061226785182953),
    icp_iterations=20, overflow=0, icp_error=10339.123046875)
# (c) the same in float64, from `JAX_PLATFORMS=cpu python3
# tools/icp_grid_witness.py` (k = 20): the port on the CPU gives it to
# 1.2e-14 in t and 2.2e-16 in R after every k of 1, 2, 3, 5, 10, 20. In
# float32 JAX's own t is 4.3e-5 from it, the port's on the CPU 5.0e-5.
JAX_ICP_GRID_F64 = dict(
    icp_r=((0.9998150650706226, -0.01922805731530149,
            -0.00034273853720434566),
           (0.019228232296739558, 0.9998149879313614, 0.0005147723319148347),
           (0.00033277705453618566, -0.000521267388740397,
            0.999999808769852)),
    icp_t=(-1.1933350189008776, 1.3153428529677182, 0.10064539043245091),
    icp_iterations=20)
# (d) cluster_scan(halo_merge=True, halo_cap=64) on the tier-2 cloud
JAX_HALO = dict(
    n_clusters=910,
    label_sha256=(
        "b8cdf8538fde2bca2c85e25e1223debbeb8d90fbed38489a56ff5afd9ead9d54"))

# The JAX package's answers for the tier-4 phase (slam_pipeline_ba and
# scan_to_map on tools/tier4_inputs.py's scans) in float32 (x64 off) and
# float64 on the CPU, poses included, from `JAX_PLATFORMS=cpu python3
# tools/jax_reference_tier4.py --out tools/tier4_reference.json` (jax 0.9.0).
TIER4_REFERENCE = os.path.join(ROOT, "tools", "tier4_reference.json")
F64_POSE_TOL = 1e-9             # float64 poses against JAX's float64 run
# A float32 ATE is held to JAX's float64 ATE within this many times JAX's
# own largest float32-vs-float64 ATE gap: over the three SLAM stages for
# them (1.8e-5, 2.2e-5, 3.5e-8 m: 2.2e-5), over scan-to-map for it
# (1.3e-3 m), and likewise the float32 map size (2,137 against 2,237).
# Each ICP's Horn solve sums 2,048 float32 points of ~30 m: its float32
# rounding (~sqrt(2048) * 2^-24 * 30 m ~ 8e-5 m) depends on the order of
# the sums, so each library's float32 run is one draw of that noise. JAX's
# pose-graph ATE lies 2.2e-5 from float64 (tools/jax_reference_tier4.py),
# the port's 3.6e-5 on the CPU and 9.3e-5 on an H100 80GB HBM3 (the card
# repeats its run bit for bit): five times JAX's gap covers them, at 1.1e-4
# m, five hundredths of the scans' 2 mm noise. JAX's float32 ICP also
# takes the jnp NN (|a|^2 - 2ab + |b|^2, ~5e-5 m^2 of rounding at 30 m),
# so its float32 neighbours are not a bit-level reference for the port's
# direct differences.
F32_GAP_FACTOR = 5.0
# The JAX package's Engine.cluster_sharded on the Engine session at the
# settings of tools/sharded_session.py, one-device mesh, float32 on the CPU,
# from `JAX_PLATFORMS=cpu python3 tools/jax_reference_sharded.py` (jax
# 0.9.0; 190, 325, 210 and 203 s a mode on an 8-core CPU): n_total and
# the SHA-256 of the int32 [B, cap] labels per mode. Every mode's overflow
# counters were 0.
_SHARDED_SHA = (
    "2e7f31cf2bffaa6309dfe438f1185268bee54bdccdb644863e3ba15b17b320dd")
JAX_SHARDED = {
    "hier": dict(n_total=420, label_sha256=_SHARDED_SHA),
    "ring": dict(n_total=420, label_sha256=_SHARDED_SHA),
    "hier_dist_split": dict(n_total=420, label_sha256=_SHARDED_SHA),
    "centroid_merge": dict(
        n_total=418, label_sha256=(
            "bc9fe0e20c5e0a7f320d251b9cd9c257051a3b5d8bc1ccaf4af75bba2185da58")),
}
# sharded ICP against the single-device ICP on the card: the moment-form
# Horn solve in float32 against K5's float64 moments (2.2e-6 on an H100 at
# tier 3)
SHARDED_ICP_TOL = 1e-5
# K5 against icp_step_plain, step by step from one state: R and t (float32,
# |t| up to ~40 m at tier 2) within 1e-6 -- both round the same float64
# moments' solve (Jacobi against eigh) to float32
K5_POSE_TOL = 1e-6
K5_STEPS = 4
TIER4_STAGES = ("odometry", "closures", "posegraph", "observations", "ba")

N_POINTS = 500_000
BLOCK_CAP = 1024
MAX_BLOCKS = 489
EPS = 0.004
MIN_PTS = 8
NOISE_CAP = 4096
MAX_CLUSTERS = 1024
CLUSTER_CAP = 1024
MAX_HULL = 32
ICP_ITERS = 50
SHAPES_RTOL = 2e-5
SHAPES_ATOL = 1e-6
STAGES = ("partition_gather", "dbscan", "fusion", "stats", "bucket",
          "shapes_x2", "icp")
# the tier-2 job's settings in the form of tools/tier3_inputs.TIER3
TIER2 = dict(n_points=N_POINTS, block_cap=BLOCK_CAP, max_blocks=MAX_BLOCKS,
             eps=EPS, min_pts=MIN_PTS, metric="l1_motor", noise_cap=NOISE_CAP,
             noise_cell_cap=32, max_clusters=MAX_CLUSTERS,
             cluster_cap=CLUSTER_CAP, max_hull=MAX_HULL, shape_chunk_k=256,
             icp_iterations=ICP_ITERS, icp_chunk=1024)
ENGINE_STEPS = ("import", "filter", "cluster", "reject", "register",
                "register_multistart", "register_ransac", "match", "export")
ICP_GRID_TOL = 2e-5             # grid ICP against brute-force ICP
JAX_ICP_GRID_TOL = 1e-5         # grid ICP's R against the JAX CPU result
F64_ICP_GRID_TOL = 1e-9         # float64 grid ICP against JAX's float64
# float32 grid ICP's t against JAX's float64 answer: float32 sums of
# 100,000 terms in another order than XLA's, over 20 iterations. JAX's own
# float32 t lies 4.3e-5 from that answer (PERF.md, section 6)
F32_ICP_GRID_T_TOL = 2e-4
PRUNE_CAP = 192                 # phase (e): candidate-pruning slots
ENGINE_MAX_HULL = 64            # Engine.cluster leaves cluster_scan's default
RADIUS_SESSION_ROWS = 65_536
RADIUS_L2_EPS = 0.002           # metres; median count ~ a few hundred
RADIUS_SIGNED_TARGET = 200      # the signed-sum eps puts the median here
RADIUS_SAMPLE = 16_384
RADIUS_FULL_PLAIN_S = 20.0
RADIUS_LIB_CHUNK = 4096         # K4's yardstick: [4096, N] f32 distances
# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s, and 67 TFLOP/s in FP32 outside the tensor cores, which counts a
# fused multiply-add as two operations: an FP32 add, subtract, multiply or
# compare issues at half that rate. The kernels are built with
# --fmad=false and issue no FMA, so their bounds count FP32 instructions
# at FP32_INSTR_PER_S. A kernel's bound is the larger of its bytes (each
# input read once, each output written once) and its instructions
# (counted from this run's inputs) over these rates.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
# FP32 instructions of an l1_motor pair test (K1, K4) a coordinate: D
# subtractions, D - 1 additions (|.| is an operand modifier) and one
# comparison, 2 D a pair. The metric is symmetric, so the least work tests
# each unordered pair of distinct valid points once: nv (nv - 1) / 2 pairs
L1_PAIR_INSTR = 2
NN_PAIR_INSTR = 8               # K3: 3 sub, 3 mul, 2 add a pair


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_name() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn over reps calls (CUDA events, one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_instr):
    """The kernels-line bound fields: the least time the card could take
    for n_bytes of traffic and n_instr FP32 instructions, and which
    bounds."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_instr / FP32_INSTR_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": int(n_bytes), "bound_instr": int(n_instr)}


def l1_pair_instr(nv, d):
    """FP32 instructions of the least l1_motor pair tests of nv valid
    points (a float64 tensor of counts) at D = d."""
    return float((nv * (nv - 1) / 2).sum()) * L1_PAIR_INSTR * d


def k2_ops(points, valid, max_hull):
    """K2's FP32 instructions on these tables, from each table's valid
    count n and hull size h (the plain gift wrap): the wrap, h steps of a
    pseudo-angle (~7) over n points; the MEC, C(h, 2) pair and C(h, 3)
    triple circles (~9 and ~25) each tested against h hull points (6); the
    rectangle, h edges (~8) projecting h points (10)."""
    from vtkcloudpoint_tpu_torch.ops.geometry import convex_hull

    h = convex_hull(points, valid, max_hull)[1].sum(dim=1).double()
    n = valid.sum(dim=1).double()
    pairs, triples = h * (h - 1) / 2, h * (h - 1) * (h - 2) / 6
    ops = (7 * h * n + pairs * (9 + 6 * h) + triples * (25 + 6 * h)
           + h * (8 + 10 * h))
    return float(ops.sum()), float(h.mean())


def sha256_of(label) -> str:
    """SHA-256 of a label tensor as int32 bytes (the JAX tools' digest)."""
    return hashlib.sha256(
        label.cpu().numpy().astype(np.int32).tobytes()).hexdigest()


def kernel_modules():
    """K1-K3's and K5's wrapper modules by kernels-line name; each keeps the
    count of its kernel's launches under LAUNCH_COUNTER's name."""
    from vtkcloudpoint_tpu_torch.kernels import dbscan as k_dbscan
    from vtkcloudpoint_tpu_torch.kernels import icp as k_icp
    from vtkcloudpoint_tpu_torch.kernels import neighbor as k_nn
    from vtkcloudpoint_tpu_torch.kernels import shapes as k_shapes

    return {"dbscan_block": k_dbscan, "cluster_shapes": k_shapes,
            "nn_argmin": k_nn, "icp_step": k_icp}


LAUNCH_COUNTER = {"icp_step": "step_launches"}


def reset_launches():
    for name, mod in kernel_modules().items():
        setattr(mod, LAUNCH_COUNTER.get(name, "launches"), 0)


def read_launches():
    import torch

    torch.cuda.synchronize()
    return {name: getattr(mod, LAUNCH_COUNTER.get(name, "launches"))
            for name, mod in kernel_modules().items()}


def hold_k1(bc, bv, eps, min_pts, where):
    """K1 against dbscan_blocks on the same blocks (bit-equal), launched
    twice (the union-find's atomics may run in any order: the two results
    must be equal), both timed. Returns the kernels-line fields."""
    import torch

    from vtkcloudpoint_tpu_torch.cluster.dbscan import dbscan_blocks
    from vtkcloudpoint_tpu_torch.kernels import dbscan as k_dbscan

    kout = k_dbscan.dbscan_blocks_cuda(bc, bv, eps, min_pts)
    again = k_dbscan.dbscan_blocks_cuda(bc, bv, eps, min_pts)
    pout = dbscan_blocks(bc, bv, eps, min_pts)
    for key in ("label", "n_clusters", "core"):
        require(torch.equal(kout[key], again[key]),
                f"K1 {key} differs between two launches ({where})")
        require(torch.equal(kout[key], pout[key]),
                f"K1 {key} differs from the plain version ({where})")
    B, cap, d = bc.shape
    nv = bv.sum(dim=1).double()
    return {"max_abs_err": float((kout["label"] - pout["label"]).abs().max()),
            "ms": cuda_ms(lambda: k_dbscan.dbscan_blocks_cuda(
                bc, bv, eps, min_pts), 20),
            "plain_ms": cuda_ms(lambda: dbscan_blocks(bc, bv, eps, min_pts),
                                3),
            **bound(B * cap * (4 * d + 1) + B * cap * 5 + B * 4,
                    l1_pair_instr(nv, d)),
            "library_ms": None,
            "shape": "B=%d cap=%d D=%d" % tuple(bc.shape)}


def hold_k2(points, valid, max_hull, where):
    """K2 against shapes_plain on the same tables (rtol SHAPES_RTOL), both
    timed. Returns the kernels-line fields."""
    from vtkcloudpoint_tpu_torch.kernels import build
    from vtkcloudpoint_tpu_torch.kernels import shapes as k_shapes

    kout = k_shapes.shapes_cuda(points, valid, max_hull)
    pout = k_shapes.shapes_plain(points, valid, max_hull)
    err = 0.0
    for name, a, b in zip(("center_x", "center_y", "radius", "len_long",
                           "len_short", "area"), kout, pout):
        bad = (a - b).abs() > SHAPES_ATOL + SHAPES_RTOL * b.abs()
        require(not bool(bad.any()),
                f"K2 {name} differs from the plain version ({where}) at "
                f"clusters {bad.nonzero()[:5].flatten().tolist()}")
        err = max(err, float((a - b).abs().max()))
    K, cap = points.shape[:2]
    ops, mean_h = k2_ops(points, valid, max_hull)
    return {"max_abs_err": err,
            "ms": cuda_ms(lambda: k_shapes.shapes_cuda(points, valid,
                                                       max_hull), 20),
            "plain_ms": cuda_ms(lambda: k_shapes.shapes_plain(
                points, valid, max_hull), 3),
            **bound(K * cap * 9 + K * 4 + K * 7 * 4, ops),
            "library_ms": None, "mean_hull": mean_h,
            "warps_a_cluster": build.load().vtkcp_shapes_group(K, cap,
                                                               max_hull),
            "shape": "K=%d cap=%d h=%d" % (K, cap, max_hull)}


def hold_k3(query, ref, ref_valid, where):
    """K3 against nn_plain on the same points (bit-equal), both timed.
    Returns the kernels-line fields."""
    import torch

    from vtkcloudpoint_tpu_torch.kernels import build
    from vtkcloudpoint_tpu_torch.kernels import neighbor as k_nn

    args = (query, ref, ref_valid)
    kidx, kd2 = k_nn.nn_cuda(*args)
    pidx, pd2 = k_nn.nn_plain(*args, 1024)
    require(torch.equal(kidx, pidx) and torch.equal(kd2, pd2),
            f"K3 differs from the plain version ({where})")
    n, m = query.shape[0], ref.shape[0]
    qpb = build.load().vtkcp_nn_queries_per_block()
    valid_ref = ref[ref_valid].contiguous()
    # the distance matrix is held to 2^30 floats (4 GiB) a call: one call
    # up to 4,096 x 100,000, queries in slices beyond
    rows = max(1, (1 << 30) // max(1, valid_ref.shape[0]))
    # one timed library run where it takes seconds (N * M beyond 5e8)
    lib_reps = 5 if n * valid_ref.shape[0] <= 500_000_000 else 1

    def library():
        # the nearest library composition (direct differences); the port
        # never calls it
        return torch.cat([torch.cdist(q, valid_ref, compute_mode=(
            "donot_use_mm_for_euclid_dist")).min(dim=1).values
            for q in query.split(rows)])

    lib_d = library()
    require(torch.allclose(lib_d * lib_d, kd2, rtol=1e-5, atol=1e-12),
            f"torch.cdist's nearest distances differ from K3's ({where})")
    return {"max_abs_err": float((kd2 - pd2).abs().max()),
            "ms": cuda_ms(lambda: k_nn.nn_cuda(*args), 20),
            "plain_ms": cuda_ms(lambda: k_nn.nn_plain(*args, 1024), 3),
            **bound(n * 12 + m * 13 + n * 8,
                    n * int(ref_valid.sum()) * NN_PAIR_INSTR),
            "library_ms": cuda_ms(library, lib_reps),
            "library_calls": -(-n // rows), "library_reps": lib_reps,
            "grid": "%d x %d blocks" % (-(-n // qpb), k_nn.nn_splits(
                n, m, qpb, k_nn.NN_BLOCKS_PER_SM * k_nn.sm_count(
                    query.device.index))[0]),
            "shape": "N=%d M=%d" % (n, m)}


def hold_k5(src, sv, tgt, tv, cfg, where):
    """K5 against icp_step_plain: K5_STEPS steps of icp from its start pose,
    each from one state and K3's answer for its moved sources; R and t
    within K5_POSE_TOL, d within one float32 ulp, the flags equal. Both
    timed on a state that never converges (tol -1). Returns the
    kernels-line fields."""
    import torch

    from vtkcloudpoint_tpu_torch.kernels import icp as k_icp
    from vtkcloudpoint_tpu_torch.kernels import neighbor as k_nn
    from vtkcloudpoint_tpu_torch.register.icp import _start

    src, sv, tgt = src.contiguous(), sv.contiguous(), tgt.contiguous()
    start = _start(src, sv, tgt, tv, cfg, None, None)
    state = k_icp.init_state(*start, src)
    err = 0.0
    for step in range(K5_STEPS):
        idx, d2 = k_nn.nn_cuda(state.p, tgt, tv)
        plain = k_icp.StepState(*(x.clone() for x in state))
        k_icp.icp_step_cuda(state, idx, d2, src, sv, tgt, cfg.tol,
                            cfg.max_iterations)
        k_icp.icp_step_plain(plain, idx, d2, src, sv, tgt, cfg.tol,
                             cfg.max_iterations)
        gap = float((state.pose[:12] - plain.pose[:12]).abs().max())
        dk, dp = float(state.pose[12]), float(plain.pose[12])
        require(torch.equal(state.flags, plain.flags) and gap <= K5_POSE_TOL
                and abs(dk - dp) <= np.spacing(np.float32(abs(dp))),
                f"K5 differs from the plain version ({where}) at step "
                f"{step}: R, t {gap}, d {dk} vs {dp}, flags "
                f"{state.flags.tolist()} vs {plain.flags.tolist()}")
        err = max(err, gap)
    timed = k_icp.init_state(*start, src)
    idx, d2 = k_nn.nn_cuda(timed.p, tgt, tv)
    plain = k_icp.StepState(*(x.clone() for x in timed))

    def step(fn, st):
        return lambda: fn(st, idx, d2, src, sv, tgt, -1.0, 2**30)

    n, n_valid = src.shape[0], int(sv.sum())
    return {"max_abs_err": err,
            "ms": cuda_ms(step(k_icp.icp_step_cuda, timed), 200),
            "plain_ms": cuda_ms(step(k_icp.icp_step_plain, plain), 20),
            # p, idx, d2 and the valid byte in, 12 a gathered target row,
            # source in and the next p out
            **bound(n * (12 + 4 + 4 + 1) + n_valid * 12 + n * 24, 0),
            "library_ms": None, "steps": K5_STEPS,
            "shape": "N=%d valid=%d M=%d" % (n, n_valid, tgt.shape[0])}


def first_icp_query(stats, truth):
    """ICP's first correspondence query: the cluster centres moved by the
    offset of the truth's centroid from theirs."""
    w = (stats["count"] > 0).float()
    centers = stats["center3d"]
    return (centers + truth.mean(dim=0) - (centers * w[:, None]).sum(dim=0)
            / w.sum().clamp_min(1.0)).contiguous()


def add_fields(kernels, rows, suffix):
    """Add each kernel's row of fields to its kernels-line entry, keys
    suffixed."""
    for k in kernels:
        if k["name"] in rows:
            k.update({f"{key}_{suffix}": v
                      for key, v in rows[k["name"]].items()})


def tier2_inputs(dev):
    """The bench cloud (bench.synthetic_cloud, seed 0) and configs on dev."""
    import torch

    sys.path.insert(0, ROOT)
    import bench  # numpy only at module level: the cloud generator
    from vtkcloudpoint_tpu_torch.config import (ClusterConfig,
                                                EngineConfig, ICPConfig)

    motor, xyz, truth = bench.synthetic_cloud(N_POINTS)
    return SimpleNamespace(
        T=TIER2,
        motor=torch.from_numpy(motor).to(dev),
        xyz=torch.from_numpy(xyz).to(dev),
        valid=torch.ones(N_POINTS, dtype=torch.bool, device=dev),
        truth=torch.from_numpy(truth).to(dev),
        truth_valid=torch.ones(len(truth), dtype=torch.bool, device=dev),
        cfg=EngineConfig(cluster=ClusterConfig(
            eps=EPS, min_pts=MIN_PTS, block_capacity=BLOCK_CAP)),
        icfg=ICPConfig(max_iterations=ICP_ITERS))


def tier2_job(inp, backend="auto"):
    """cluster_scan + ICP of the centres onto the truth: (ClusterResult,
    ICPResult), as bench.py:133-165 chains them."""
    from vtkcloudpoint_tpu_torch.cluster.pipeline import cluster_scan
    from vtkcloudpoint_tpu_torch.register.icp import icp

    res = cluster_scan(inp.xyz, inp.motor, inp.valid, inp.cfg,
                       mode="balanced", max_blocks=MAX_BLOCKS, quirks=False,
                       noise_capacity=NOISE_CAP, max_clusters=MAX_CLUSTERS,
                       cluster_capacity=CLUSTER_CAP, max_hull=MAX_HULL,
                       backend=backend)
    reg = icp(res.center3d, res.count > 0, inp.truth, inp.truth_valid,
              inp.icfg, chunk=1024, backend=backend)
    return res, reg


def job_stages(inp, backend="auto"):
    """The job -- bench.py's step at the settings inp.T (TIER2, or
    tools/tier3_inputs.TIER3: benchmarks/tier3_scale.py's step, parity mode,
    full stage) -- as stage callables over one namespace s, by the stage
    names of STAGES. Run in that order they are the job; each reads what
    the stages before it left in s and writes its own output there, so
    after one pass any stage can run again alone on the same inputs."""
    import torch

    from vtkcloudpoint_tpu_torch.cluster.blocks import (
        partition_gather_sorted)
    from vtkcloudpoint_tpu_torch.cluster.dbscan import dbscan_blocks_dispatch
    from vtkcloudpoint_tpu_torch.cluster.fusion import merge_blocks
    from vtkcloudpoint_tpu_torch.config import ICPConfig
    from vtkcloudpoint_tpu_torch.ops.geometry import cluster_shapes
    from vtkcloudpoint_tpu_torch.ops.segment import (
        bucket_payload_by_cluster, cluster_stats)
    from vtkcloudpoint_tpu_torch.register.icp import icp

    T, s = inp.T, SimpleNamespace()
    n = inp.motor.shape[0]

    def partition():
        s.bc, s.bv, s.pidx, s.gather_overflow = partition_gather_sorted(
            inp.motor, inp.valid, T["block_cap"], T["max_blocks"])

    def dbscan():
        s.db = dbscan_blocks_dispatch(s.bc, s.bv, T["eps"], T["min_pts"],
                                      T["metric"], backend=backend)

    def fusion():
        s.fused = merge_blocks(
            s.db["label"], s.bv, s.bc, s.pidx, n, T["eps"], T["min_pts"],
            T["metric"], quirks=False, noise_capacity=T["noise_cap"],
            noise_cell_cap=T["noise_cell_cap"])

    def stats():
        s.stats = cluster_stats(inp.xyz, inp.motor, s.fused["label"],
                                inp.valid, T["max_clusters"])

    def bucket():
        pay = (inp.xyz[:, 0], inp.xyz[:, 1], inp.motor[:, 0],
               inp.motor[:, 1])
        tabs, tval, runs, s.bucket_overflow = bucket_payload_by_cluster(
            s.fused["label"], inp.valid, pay, T["max_clusters"],
            T["cluster_cap"])
        s.both = torch.cat([tabs[..., 0:2], tabs[..., 2:4]]).contiguous()
        s.bval = torch.cat([tval, tval])
        s.bcnt = torch.cat([runs, runs])

    def shapes_x2():
        s.shapes = cluster_shapes(s.both, s.bval, s.bcnt,
                                  max_hull=T["max_hull"],
                                  chunk_k=T["shape_chunk_k"], backend=backend)

    def icp_stage():
        s.reg = icp(s.stats["center3d"], s.stats["count"] > 0, inp.truth,
                    inp.truth_valid,
                    ICPConfig(max_iterations=T["icp_iterations"]),
                    chunk=T["icp_chunk"], backend=backend)

    fns = (partition, dbscan, fusion, stats, bucket, shapes_x2, icp_stage)
    return dict(zip(STAGES, fns)), s


def staged_job(inp, backend="auto", timer=None):
    """One pass of job_stages, each stage under ``timer`` if given. Returns
    the namespace of its outputs."""
    stages, s = job_stages(inp, backend)
    for name, fn in stages.items():
        with timer(name) if timer else contextlib.nullcontext():
            fn()
    return s


def tier2_stages(inp, backend="auto"):
    """The tier-2 job's stages (job_stages at TIER2), after one pass: the
    namespace holds every intermediate."""
    stages, s = job_stages(inp, backend)
    for fn in stages.values():
        fn()
    return stages, s


class StepTimer:
    """Per-step host wall ms (ending in a synchronise) and CUDA-event ms
    (the stream's span between two events) of the steps run under it."""

    def __init__(self):
        self.wall, self.device = {}, {}

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        yield
        end.record()
        end.synchronize()
        self.wall[name] = (time.perf_counter() - t0) * 1e3
        self.device[name] = start.elapsed_time(end)


def engine_session_inputs():
    """The numpy session of tools/engine_session.py: motor, rng, truth."""
    sys.path.insert(0, ROOT)
    from tools.engine_session import engine_session

    motor, rng, truth = engine_session()
    return SimpleNamespace(motor=motor, rng=rng, truth=truth)


def engine_run(sess, dev, backend="auto", outdir=None, timer=None):
    """The Engine session on ``dev``: the steps of ENGINE_STEPS, each under
    ``timer``. Multi-start and RANSAC draw from CPU generators seeded 0, so
    every run samples the same. Returns the results of every step."""
    import torch

    from tools.engine_session import SESSION, engine_config
    from vtkcloudpoint_tpu_torch.engine import Engine

    timer = timer or StepTimer()

    def engine(**icp):
        return Engine(engine_config(**icp).replace(backend=backend),
                      device=dev)

    eng = engine()
    with timer("import"):
        batch = eng.import_arrays(sess.motor, sess.rng,
                                  capacity=SESSION["capacity"])
    with timer("filter"):
        batch = eng.filter_by_distance(batch, SESSION["dis_min"],
                                       SESSION["dis_max"])
    with timer("cluster"):
        res = eng.cluster(batch, **SESSION["cluster"])
    with timer("reject"):
        kept, rejected = eng.reject_by_radius(
            batch, res, radius=SESSION["reject_radius"])
    with timer("register"):
        reg = eng.register_to_truth(res, sess.truth, coarse=True)
    with timer("register_multistart"):
        reg_ms = engine(num_starts=SESSION["num_starts"]).register_to_truth(
            res, sess.truth, generator=torch.Generator().manual_seed(0))
    with timer("register_ransac"):
        reg_rs = engine(ransac_iters=SESSION["ransac_iters"]) \
            .register_to_truth(res, sess.truth,
                               generator=torch.Generator().manual_seed(0))
    with timer("match"):
        m = eng.match(res, sess.truth, reg)
    files = {}
    with timer("export"):
        if outdir is not None:
            files = {"centroids": os.path.join(outdir, "centroids.txt"),
                     "points": os.path.join(outdir, "points.txt")}
            eng.export_centroids(files["centroids"], res)
            eng.export_cluster_points(files["points"], kept, res)
    return SimpleNamespace(batch=batch, res=res, kept=kept,
                           rejected=rejected, reg=reg, reg_ms=reg_ms,
                           reg_rs=reg_rs, match=m, files=files)


def radius_phase(inp, s, k1_core, card):
    """K4 through its own entry point, then held against its plain version.
    Returns the kernels-line entry."""
    import torch

    from vtkcloudpoint_tpu_torch.data.convert import distance_window, \
        motor_to_xyz
    from vtkcloudpoint_tpu_torch.kernels import neighbor as k_nn

    sess = engine_session_inputs()
    rows = RADIUS_SESSION_ROWS
    motor = torch.from_numpy(sess.motor[:rows]).to(inp.motor.device)
    dist = torch.from_numpy(sess.rng[:rows]).to(inp.motor.device)
    xyz = motor_to_xyz(motor, dist).contiguous()
    xyz_valid = distance_window(dist, 40.5, 44.5)
    xy = xyz[:, :2].contiguous()
    # signed sum: count(q) = #{r : s_r >= s_q - eps}, s = x + y, so the
    # median query sees ~RADIUS_SIGNED_TARGET points at eps = median(s) -
    # quantile(s, 1 - target / n); eps is negative
    ssum = xy.sum(dim=1)[xyz_valid].double()
    eps_signed = float(ssum.median() - torch.quantile(
        ssum.cpu(), 1.0 - RADIUS_SIGNED_TARGET / ssum.numel()))
    cases = {
        "a_l1_motor_500k": (inp.motor, inp.valid, EPS, "l1_motor"),
        "c_l2_xyz_session": (xyz, xyz_valid, RADIUS_L2_EPS, "l2_xyz"),
        "d_signed_sum_xy_session": (xy, xyz_valid, eps_signed,
                                    "signed_sum_xy"),
    }

    # ---- the path: K4's entry point, counts read around it ----
    k_nn.radius_launches = 0
    got = {name: k_nn.radius_count(*args) for name, args in cases.items()}
    blocks = [k_nn.radius_count(s.bc[b], s.bv[b], EPS, "l1_motor")
              for b in range(16)]
    torch.cuda.synchronize()
    launches = k_nn.radius_launches
    require(launches == len(cases) + 16,
            f"K4 launched {launches} times on its path")

    # (b) count >= min_pts is K1's core flag, block by block
    for b, cnt in enumerate(blocks):
        require(torch.equal(cnt >= MIN_PTS, k1_core[b]),
                f"K4 counts of block {b} disagree with K1's core flags")

    again = k_nn.radius_count(*cases["a_l1_motor_500k"])
    require(torch.equal(again, got["a_l1_motor_500k"]),
            "K4 differs between two launches (its atomics may run in any "
            "order; their sums may not)")

    report, err = {}, 0.0
    for name, (coords, valid, eps, metric) in cases.items():
        n = coords.shape[0]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        first = torch.arange(min(2048, n), device=coords.device)
        k_nn.radius_count_plain(coords, valid, eps, metric, rows=first)
        start.record()          # timed after a warm-up: allocation out
        k_nn.radius_count_plain(coords, valid, eps, metric, rows=first)
        end.record()
        end.synchronize()
        estimate_s = start.elapsed_time(end) / 1e3 * n / first.numel()
        if estimate_s < RADIUS_FULL_PLAIN_S:
            compared, rows_idx = "all rows", None
        else:
            g = torch.Generator().manual_seed(0)
            rows_idx = torch.randperm(n, generator=g)[:RADIUS_SAMPLE].to(
                coords.device)
            compared = f"{RADIUS_SAMPLE} sampled rows (seed 0)"
        start.record()
        plain = k_nn.radius_count_plain(coords, valid, eps, metric,
                                        rows=rows_idx)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        mine = got[name] if rows_idx is None else got[name][rows_idx]
        diff = (mine - plain).abs()
        require(not bool(diff.any()),
                f"K4 {name} differs from the plain version at rows "
                f"{diff.nonzero()[:5].flatten().tolist()}")
        err = max(err, float(diff.max()))
        counts = got[name][valid].float()
        median = float(counts.median())
        require(name.startswith("a_") or 8 <= median <= 1000,
                f"K4 {name}: median count {median} outside [8, 1000]")
        report[name] = {
            "n": n, "eps": eps, "metric": metric, "compared": compared,
            "plain_estimate_s": estimate_s, "median_count": median,
            "ms": cuda_ms(lambda: k_nn.radius_count_cuda(coords, valid, eps,
                                                         metric), 3),
            "plain_ms": plain_ms, "plain_rows": int(plain.numel())}
    a = report["a_l1_motor_500k"]
    coords, valid, eps = cases["a_l1_motor_500k"][:3]
    n, d = coords.shape
    lib = radius_library(coords, valid, eps, got["a_l1_motor_500k"])
    print(json.dumps({"phase": "radius_count", "card": card,
                      "launches": launches, "blocks_equal_k1_core": 16,
                      "two_launches_equal": True, **report,
                      "library": lib}))
    return {"name": "radius_count", "route": "cuda",
            "source": k_nn.RADIUS_SOURCE, "replaces": k_nn.RADIUS_REPLACES,
            "launches": launches, "max_abs_err": err, "ms": a["ms"],
            "plain_ms": a["plain_ms"],
            **bound(n * (4 * d + 1) + n * 4,
                    l1_pair_instr(valid.sum().double(), d)),
            "library_ms": lib["ms"], "shape": "N=%d D=%d l1_motor" % (n, d)}


def radius_library(coords, valid, eps, counts):
    """K4's yardstick: (torch.cdist(q, ref[valid], p=1) <= eps).sum(1),
    RADIUS_LIB_CHUNK queries at a time (the port never calls it), timed
    over all rows once after a one-chunk warm-up (~5 minutes at N =
    500,000 on an H100: cdist's p = 1 kernel), its counts set beside K4's
    ``counts`` on every valid row. p = 1 sums |dx| + |dy| in its own order,
    so rows may differ at the eps boundary: they are counted, not
    refused."""
    import torch

    ref = coords[valid].contiguous()

    def library(q):
        return torch.cat([
            (torch.cdist(q[s:s + RADIUS_LIB_CHUNK], ref, p=1) <= eps).sum(
                dim=1, dtype=torch.int32)
            for s in range(0, q.shape[0], RADIUS_LIB_CHUNK)])

    library(coords[:RADIUS_LIB_CHUNK])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    mine = library(coords)
    end.record()
    end.synchronize()
    diff = (mine - counts)[valid].abs()
    return {"ms": start.elapsed_time(end), "chunk": RADIUS_LIB_CHUNK,
            "rows_compared": int(diff.numel()),
            "rows_differ": int((diff > 0).sum()),
            "max_abs_diff": int(diff.max())}


def engine_phase(dev, card, kernels):
    """The Engine session through the kernels and with the plain versions,
    checked against each other and the JAX constants; K2 at h = 64 against
    its plain version at the session's shapes."""
    import torch

    from vtkcloudpoint_tpu_torch.ops.segment import bucket_payload_by_cluster

    sess = engine_session_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "plain"))
        os.makedirs(os.path.join(tmp, "cuda"))
        t0 = time.perf_counter()
        plain = engine_run(sess, dev, "torch", os.path.join(tmp, "plain"))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0

        reset_launches()
        timer = StepTimer()
        run = engine_run(sess, dev, "auto", os.path.join(tmp, "cuda"),
                         timer)
        launches = read_launches()
        for name, n in launches.items():
            require(n > 0, f"kernel {name} did not launch in the Engine "
                           f"session")
        for key in ("centroids", "points"):
            with open(run.files[key]) as fa, open(plain.files[key]) as fb:
                require(fa.read() == fb.read(),
                        f"exported {key} differ from the plain run")

    res = run.res
    require(int(res.block_overflow) == 0, "Engine session block overflow")
    require(int(res.noise_overflow) == 0, "Engine session noise overflow")
    require(torch.equal(res.label, plain.res.label),
            "Engine labels differ from the plain run")
    require(torch.equal(run.rejected, plain.rejected),
            "rejected mask differs from the plain run")
    require(torch.equal(run.match["match_idx"], plain.match["match_idx"])
            and torch.equal(run.match["is_matched"],
                            plain.match["is_matched"]),
            "match indices differ from the plain run")
    regs = {}
    for key in ("reg", "reg_ms", "reg_rs"):
        a, b = getattr(run, key), getattr(plain, key)
        r, t = a.r.cpu().numpy(), a.t.cpu().numpy()
        require(np.isfinite(r).all() and np.isfinite(t).all()
                and np.allclose(r.T @ r, np.eye(3), atol=1e-5),
                f"{key}: not a finite rotation")
        require(np.allclose(r, b.r.cpu().numpy(), atol=1e-5)
                and np.allclose(t, b.t.cpu().numpy(), atol=1e-5),
                f"{key}: R, t differ from the plain run")
        regs[key] = {"r": r.tolist(), "t": t.tolist(),
                     "iterations": int(a.iterations),
                     "error": float(a.error)}

    got = {"n_clusters": int(res.n_clusters),
           "label_sha256": sha256_of(res.label),
           "n_rejected": int(run.rejected.sum()),
           "n_matched": int(run.match["n_matched"])}
    for key, value in got.items():
        require(value == JAX_ENGINE[key],
                f"Engine {key} {value} != JAX CPU {JAX_ENGINE[key]}")
    require(np.allclose(regs["reg"]["r"], JAX_ENGINE["icp_r"], atol=1e-4)
            and np.allclose(regs["reg"]["t"], JAX_ENGINE["icp_t"],
                            atol=1e-4),
            f"Engine R, t {regs['reg']} far from the JAX CPU result")

    # K2 at the Engine's h = 64, at the session's shapes
    b = run.batch
    pay = (b.xyz[:, 0], b.xyz[:, 1], b.motor[:, 0], b.motor[:, 1])
    tabs, tval, _, _ = bucket_payload_by_cluster(
        res.label, b.valid, pay, MAX_CLUSTERS, CLUSTER_CAP)
    both = torch.cat([tabs[..., 0:2], tabs[..., 2:4]], dim=0).contiguous()
    bval = torch.cat([tval, tval])
    row = hold_k2(both, bval, ENGINE_MAX_HULL, "Engine session")
    add_fields(kernels, {"cluster_shapes": row}, "h64")
    add_fields(kernels, {name: {"launches": n}
                         for name, n in launches.items()}, "engine")

    print(json.dumps({
        "phase": "engine", "card": card, "n_points": len(sess.rng),
        "n_filtered": int(b.count), **got, "jax_cpu_matches": True,
        "labels_equal_plain_run": True,
        "block_overflow": int(res.block_overflow),
        "noise_overflow": int(res.noise_overflow),
        "launches": launches, "max_hull": ENGINE_MAX_HULL,
        "k2_h64": row["shape"],
        "rmse": float(run.match["rmse"]), **regs,
        "plain_run_seconds": plain_s}))
    print(json.dumps({"phase": "engine_step_ms", "card": card,
                      "wall_ms": timer.wall, "event_ms": timer.device,
                      "wall_sum": sum(timer.wall.values())}))


def tier3_inputs(dev):
    """The tier-3 cloud and settings of tools/tier3_inputs.py on ``dev``."""
    import torch

    sys.path.insert(0, ROOT)
    from tools.tier3_inputs import TIER3, tier3_cloud

    motor, xyz, truth, k_true = tier3_cloud()
    return SimpleNamespace(
        T=TIER3, k_true=k_true,
        motor=torch.from_numpy(motor).to(dev),
        xyz=torch.from_numpy(xyz).to(dev),
        valid=torch.ones(len(motor), dtype=torch.bool, device=dev),
        truth=torch.from_numpy(truth).to(dev),
        truth_valid=torch.ones(len(truth), dtype=torch.bool, device=dev))


def tier3_result(s):
    """The numbers of a tier-3 run that tools/jax_reference_tier3.py gives
    for the JAX package (the bucket overflow without row 0, the noise row,
    as benchmarks/tier3_scale.py counts it)."""
    return {"n_clusters": int(s.fused["n_total"]),
            "label_sha256": sha256_of(s.fused["label"]),
            "noise_overflow": int(s.fused["noise_overflow"]),
            "gather_overflow": int(s.gather_overflow.sum()),
            "bucket_overflow": int(s.bucket_overflow[1:].sum()),
            "icp_iterations": int(s.reg.iterations),
            "icp_r": s.reg.r.cpu().numpy().tolist(),
            "icp_t": s.reg.t.cpu().numpy().tolist(),
            "icp_error": float(s.reg.error)}


def tier3_phase(dev, card, kernels):
    """(a) The 5M-point tier-3 job through the kernels and with the plain
    versions, checked against each other and the JAX CPU constants; K1-K3
    and K5 held to their plain versions at its shapes; the noise stage on the grid
    engine against dense_chunked. Returns (inputs, the job's namespace)."""
    import torch

    from vtkcloudpoint_tpu_torch.cluster.fusion import merge_blocks
    from vtkcloudpoint_tpu_torch.config import ICPConfig

    inp = tier3_inputs(dev)
    T = inp.T
    t0 = time.perf_counter()
    plain = staged_job(inp, "torch")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0

    reset_launches()
    timer = StepTimer()
    t0 = time.perf_counter()
    s = staged_job(inp, "auto", timer)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    for name, n in launches.items():
        require(n > 0, f"kernel {name} did not launch in the tier-3 job")

    got, ref = tier3_result(s), tier3_result(plain)
    require(torch.equal(s.fused["label"], plain.fused["label"]),
            "tier-3 labels differ from the plain run")
    for key in ("n_clusters", "label_sha256", "noise_overflow",
                "gather_overflow", "bucket_overflow"):
        require(got[key] == JAX_TIER3[key],
                f"tier-3 {key} {got[key]} != JAX CPU {JAX_TIER3[key]}")
    require(got["icp_iterations"] == JAX_TIER3["icp_iterations"],
            f"tier-3 ICP iterations {got['icp_iterations']} != JAX CPU "
            f"(Pallas NN) {JAX_TIER3['icp_iterations']}")
    for key in ("icp_r", "icp_t"):
        require(np.allclose(got[key], JAX_TIER3[key], atol=1e-4),
                f"tier-3 {key} {got[key]} far from the JAX CPU result")
        require(np.allclose(got[key], ref[key], atol=1e-5),
                f"tier-3 {key} differs from the plain run")
    radii = s.shapes["radius"][:T["max_clusters"]]
    require(bool(torch.isfinite(radii).all()), "tier-3 radii not finite")

    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        staged_job(inp)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    # the noise stage on the grid engine ("auto") and on dense_chunked
    def noise(engine):
        return merge_blocks(
            s.db["label"], s.bv, s.bc, s.pidx, inp.motor.shape[0], T["eps"],
            T["min_pts"], T["metric"], quirks=False,
            noise_capacity=T["noise_cap"], noise_engine=engine,
            noise_cell_cap=T["noise_cell_cap"])
    dense = noise("dense_chunked")
    require(torch.equal(dense["label"], s.fused["label"]),
            "dense_chunked noise labels differ from the grid engine's")
    noise_ms = {"grid": cuda_ms(lambda: noise("auto"), 3),
                "dense_chunked": cuda_ms(lambda: noise("dense_chunked"), 1)}

    rows = {"dbscan_block": hold_k1(s.bc, s.bv, T["eps"], T["min_pts"],
                                    "tier 3"),
            "cluster_shapes": hold_k2(s.both, s.bval, T["max_hull"],
                                      "tier 3"),
            "nn_argmin": hold_k3(first_icp_query(s.stats, inp.truth),
                                 inp.truth, inp.truth_valid, "tier 3"),
            "icp_step": hold_k5(s.stats["center3d"], s.stats["count"] > 0,
                                inp.truth, inp.truth_valid,
                                ICPConfig(max_iterations=T["icp_iterations"]),
                                "tier 3")}
    for name, n in launches.items():
        rows[name]["launches"] = n
    add_fields(kernels, rows, "tier3")
    print(json.dumps({
        "phase": "tier3_job", "card": card, "n_points": T["n_points"],
        "blocks": T["max_blocks"], "k_true": inp.k_true, **got,
        "jax_cpu_n_clusters": JAX_TIER3["n_clusters"],
        "tpu_record_n_clusters": TPU_RECORD_TIER3_N_CLUSTERS,
        "jax_cpu_matches": True, "labels_equal_plain_run": True,
        "launches": launches, "first_run_seconds": first_s,
        "plain_run_seconds": plain_s,
        "kernel_shapes": {k: v["shape"] for k, v in rows.items()}}))
    print(json.dumps({"phase": "tier3_stage_ms", "card": card,
                      "event_ms": timer.device, "wall_ms": timer.wall,
                      "event_sum": sum(timer.device.values()),
                      "job_wall_ms": walls,
                      "noise_stage_ms": noise_ms,
                      "noise_labels_equal": True}))
    return inp, s


def tier4_inputs(dev):
    """The tier-4 scans, truth and settings of tools/tier4_inputs.py on
    ``dev`` (scans float32, truth float64)."""
    import torch

    sys.path.insert(0, ROOT)
    from tools.tier4_inputs import SCAN2MAP, TIER4, tier4_scans
    from vtkcloudpoint_tpu_torch.config import ICPConfig

    scans, valid, r_true, t_true = tier4_scans()
    return SimpleNamespace(
        T=TIER4, S2M=SCAN2MAP,
        scans=torch.from_numpy(scans).to(dev),
        valid=torch.from_numpy(valid).to(dev),
        r_true=torch.from_numpy(r_true).to(dev),
        t_true=torch.from_numpy(t_true).to(dev),
        cfg=ICPConfig(max_iterations=TIER4["icp_max_iterations"],
                      tol=TIER4["icp_tol"]))


def tier4_job(inp, dtype, backend="auto", timer=None, mesh=None):
    """benchmarks/tier4_slam.py's job through the port's slam_pipeline_ba in
    ``dtype``: odometry, closures, pose graph, observations, BA, each stage
    under ``timer`` if given. Returns the three trajectories, the stats,
    the closure pairs and the ATE of each stage against the truth."""
    import torch

    from vtkcloudpoint_tpu_torch.slam.posegraph import \
        absolute_trajectory_error
    from vtkcloudpoint_tpu_torch.slam.trajectory import (detect_loop_closures,
                                                         slam_pipeline_ba)

    T = inp.T
    ba, pg, odo, stats = slam_pipeline_ba(
        inp.scans.to(dtype), inp.valid, inp.cfg,
        loop_radius=T["loop_radius"], gn_iterations=T["gn_iterations"],
        landmark_eps=T["landmark_eps"],
        landmark_min_pts=T["landmark_min_pts"],
        max_clusters_per_scan=T["max_clusters_per_scan"],
        ba_iterations=T["ba_iterations"], mesh=mesh, backend=backend,
        timer=timer)
    li, lj = detect_loop_closures(odo, T["loop_radius"])
    trajs = {"odometry": odo, "posegraph": pg, "ba": ba}
    rt, tt = inp.r_true.to(dtype), inp.t_true.to(dtype)
    ate = {k: float(absolute_trajectory_error(tr.r, tr.t, rt, tt))
           for k, tr in trajs.items()}
    return SimpleNamespace(trajs=trajs, stats=stats, pairs=[li.tolist(),
                                                            lj.tolist()],
                           ate=ate)


def tier4_s2m(inp, dtype, backend="auto"):
    """scan_to_map at tools/tier4_inputs.SCAN2MAP in ``dtype``: the
    trajectory, map and the ATE against the truth."""
    import torch

    from vtkcloudpoint_tpu_torch.slam.posegraph import \
        absolute_trajectory_error
    from vtkcloudpoint_tpu_torch.slam.scan2map import scan_to_map

    traj, mp, _ = scan_to_map(inp.scans.to(dtype), inp.valid, inp.cfg,
                              backend=backend, **inp.S2M)
    ate = float(absolute_trajectory_error(traj.r, traj.t,
                                          inp.r_true.to(dtype),
                                          inp.t_true.to(dtype)))
    return SimpleNamespace(traj=traj, map=mp, ate=ate,
                           map_size=int(mp.mask.sum()))


def _same_traj(a, b) -> bool:
    import torch

    return torch.equal(a.r, b.r) and torch.equal(a.t, b.t)


def _pose_gap(traj, ref) -> float:
    """Largest |difference| of R and t against a reference's poses."""
    return max(float(np.abs(traj.r.double().cpu().numpy()
                            - np.asarray(ref["r"])).max()),
               float(np.abs(traj.t.double().cpu().numpy()
                            - np.asarray(ref["t"])).max()))


def tier4_phase(dev, card, kernels):
    """The tier-4 SLAM job of benchmarks/tier4_slam.py at full size (100
    scans of 2,048 points) and scan-to-map on the same scans:
    (a) slam_pipeline_ba in float32 through K3 and K5, stage by stage;
    (b) the same with the plain versions on the card, equal bit for bit;
    (c) in float64 (plain versions: K3 is float32 only) against JAX's
        float64 run -- closure pairs and n_landmarks equal, every pose
        within F64_POSE_TOL -- and (a)'s ATEs against JAX's float64 ATEs,
        within F32_GAP_FACTOR times JAX's own float32 gap; the benchmark's
        two assertions on (a);
    (d) scan_to_map (grid NN, K3 fallback) in float32 through K3, equal to
        the plain run, and in float64 against JAX's float64 run;
    (e) K3 and K5 against their plain versions at the odometry shape,
        N = M = 2,048.
    Returns the inputs, JAX's reference, the float64 run and the float32
    ATE tolerance.
    """
    import torch

    from vtkcloudpoint_tpu_torch.ops import se3

    with open(TIER4_REFERENCE) as f:
        ref = json.load(f)
    inp = tier4_inputs(dev)
    t_phase = time.perf_counter()

    # (a) the path, through K3
    reset_launches()
    timer = StepTimer()
    t0 = time.perf_counter()
    run = tier4_job(inp, torch.float32, "auto", timer)
    job_s = time.perf_counter() - t0
    launches = read_launches()
    require(launches["nn_argmin"] > 0, "K3 did not launch in the tier-4 job")
    require(launches["icp_step"] > 0, "K5 did not launch in the tier-4 job")

    # (b) plain versions on the card
    t0 = time.perf_counter()
    plain = tier4_job(inp, torch.float32, "torch")
    plain_s = time.perf_counter() - t0
    plain_gaps = {key: (float((tr.r - plain.trajs[key].r).abs().max()),
                        float((tr.t - plain.trajs[key].t).abs().max()))
                  for key, tr in run.trajs.items()}
    for key in run.trajs:
        require(_same_traj(run.trajs[key], plain.trajs[key]),
                f"tier-4 {key} poses differ from the plain run: {plain_gaps}")
    require(run.pairs == plain.pairs, "closure pairs differ from the plain "
                                      "run")
    for key in ("graph_cost", "ba_cost", "n_landmarks"):
        require(torch.equal(run.stats[key], plain.stats[key]),
                f"tier-4 {key} differs from the plain run: "
                f"{float(run.stats[key])} vs {float(plain.stats[key])}")

    # (c) float64 against JAX's float64 run; float32 ATEs against its ATEs
    t0 = time.perf_counter()
    f64 = tier4_job(inp, torch.float64, "torch")
    f64_s = time.perf_counter() - t0
    r64, r32 = ref["f64"], ref["f32"]
    require(f64.pairs == r64["poses"]["pairs"],
            f"float64 closure pairs ({len(f64.pairs[0])}) differ from JAX's "
            f"({r64['slam']['n_pairs']})")
    require(int(f64.stats["n_landmarks"]) == r64["slam"]["n_landmarks"],
            f"float64 n_landmarks {int(f64.stats['n_landmarks'])} != JAX "
            f"{r64['slam']['n_landmarks']}")
    gaps64 = {k: _pose_gap(tr, r64["poses"][k]) for k, tr in f64.trajs.items()}
    require(max(gaps64.values()) <= F64_POSE_TOL,
            f"float64 poses differ from JAX's float64 run: {gaps64}")
    slam_gap = max(abs(r32["slam"]["ate_" + k] - r64["slam"]["ate_" + k])
                   for k in run.ate)
    f32_tol = F32_GAP_FACTOR * slam_gap
    f32_dev = {k: abs(v - r64["slam"]["ate_" + k]) for k, v in run.ate.items()}
    require(max(f32_dev.values()) <= f32_tol,
            f"float32 ATEs {run.ate} far from JAX's float64 ATEs (tolerance "
            f"{f32_tol})")
    ate_odo, ate_pg, ate_ba = (run.ate[k] for k in ("odometry", "posegraph",
                                                    "ba"))
    require(ate_pg <= max(ate_odo * 1.05, ate_odo + 1e-3),
            "pose graph regressed odometry (tier4_slam.py:74)")
    require(ate_ba <= max(ate_pg * 1.05, ate_pg + 1e-3),
            "BA regressed the pose graph (tier4_slam.py:75)")

    # (d) scan-to-map
    k_nn = kernel_modules()["nn_argmin"]
    k_nn.launches = 0
    t0 = time.perf_counter()
    s2m = tier4_s2m(inp, torch.float32, "auto")
    s2m_s = time.perf_counter() - t0
    s2m_launches = read_launches()["nn_argmin"]
    require(s2m_launches > 0, "K3 did not launch in scan-to-map")
    s2m_plain = tier4_s2m(inp, torch.float32, "torch")
    require(_same_traj(s2m.traj, s2m_plain.traj)
            and torch.equal(s2m.map.points, s2m_plain.map.points),
            "scan-to-map differs from the plain run")
    t0 = time.perf_counter()
    s2m64 = tier4_s2m(inp, torch.float64, "torch")
    s2m64_s = time.perf_counter() - t0
    s2m_gap64 = _pose_gap(s2m64.traj, r64["poses"]["s2m"])
    require(s2m_gap64 <= F64_POSE_TOL
            and s2m64.map_size == r64["s2m"]["map_size"],
            f"float64 scan-to-map differs from JAX's: poses {s2m_gap64}, map "
            f"{s2m64.map_size} vs {r64['s2m']['map_size']}")
    s2m_tol = F32_GAP_FACTOR * abs(r32["s2m"]["ate"] - r64["s2m"]["ate"])
    map_tol = F32_GAP_FACTOR * abs(r32["s2m"]["map_size"]
                                   - r64["s2m"]["map_size"])
    require(abs(s2m.ate - r64["s2m"]["ate"]) <= s2m_tol
            and abs(s2m.map_size - r64["s2m"]["map_size"]) <= map_tol,
            f"float32 scan-to-map ATE {s2m.ate}, map {s2m.map_size} far from "
            f"JAX's float64 {r64['s2m']['ate']}, {r64['s2m']['map_size']}")

    # (e) K3 at the odometry shape: the first ICP query of pair (0, 1)
    sc, sv = inp.scans, inp.valid
    t_init = sc[0].mean(dim=0) - sc[1].mean(dim=0)
    query = se3.apply_rigid(torch.eye(3, device=dev), t_init,
                            sc[1]).contiguous()
    row = hold_k3(query, sc[0].contiguous(), sv[0], "tier 4")
    # K5 at the odometry shape: icp's steps of pair (0, 1)
    row5 = hold_k5(sc[1], sv[1], sc[0], sv[0], inp.cfg, "tier 4")
    add_fields(kernels, {"nn_argmin": {**row,
                                       "launches": launches["nn_argmin"],
                                       "launches_s2m": s2m_launches},
                         "icp_step": {**row5,
                                      "launches": launches["icp_step"]}},
               "tier4")

    print(json.dumps({
        "phase": "tier4_slam", "card": card, "scans": inp.T["scans"],
        "points_per_scan": inp.T["points_per_scan"],
        "ate_f32": run.ate, "ate_f64": f64.ate,
        "jax_ate_f32": {k: r32["slam"]["ate_" + k] for k in run.ate},
        "jax_ate_f64": {k: r64["slam"]["ate_" + k] for k in run.ate},
        "f32_ate_dev_from_jax_f64": f32_dev, "f32_ate_tol": f32_tol,
        "f64_pose_gap": gaps64, "f64_pose_tol": F64_POSE_TOL,
        "n_pairs": len(run.pairs[0]), "n_pairs_f64": len(f64.pairs[0]),
        "jax_n_pairs_f64": r64["slam"]["n_pairs"],
        "n_landmarks": int(run.stats["n_landmarks"]),
        "graph_cost": float(run.stats["graph_cost"]),
        "ba_cost": float(run.stats["ba_cost"]),
        "equal_plain_run": True, "launches": launches,
        "job_s": job_s, "plain_job_s": plain_s, "f64_job_s": f64_s}))
    print(json.dumps({"phase": "tier4_stage_ms", "card": card,
                      "wall_ms": timer.wall, "event_ms": timer.device,
                      "wall_sum": sum(timer.wall.values())}))
    print(json.dumps({
        "phase": "tier4_scan2map", "card": card, **inp.S2M,
        "ate_f32": s2m.ate, "map_size_f32": s2m.map_size,
        "ate_f64": s2m64.ate, "map_size_f64": s2m64.map_size,
        "jax_f32": r32["s2m"], "jax_f64": r64["s2m"],
        "f32_ate_tol": s2m_tol, "f32_map_tol": map_tol,
        "f64_pose_gap": s2m_gap64, "equal_plain_run": True,
        "launches": s2m_launches, "wall_s": s2m_s, "f64_wall_s": s2m64_s,
        "phase_s": time.perf_counter() - t_phase}))
    return SimpleNamespace(inp=inp, ref=ref, f64=f64, f32_tol=f32_tol)


def grid_engine_phase(dev, card):
    """(b) Engine.cluster_grid on the Engine session at cell_cap 2048: exact
    global DBSCAN, checked against the JAX CPU constants."""
    import torch

    from tools.engine_session import SESSION, engine_config
    from tools.tier3_inputs import GRID_ENGINE
    from vtkcloudpoint_tpu_torch.engine import Engine

    sess = engine_session_inputs()
    eng = Engine(engine_config(), device=dev)
    batch = eng.filter_by_distance(
        eng.import_arrays(sess.motor, sess.rng, capacity=SESSION["capacity"]),
        SESSION["dis_min"], SESSION["dis_max"])
    reset_launches()
    t0 = time.perf_counter()
    out, stats = eng.cluster_grid(batch, **GRID_ENGINE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    count = stats["count"]
    got = {"n_clusters": int(out["n_clusters"]),
           "label_sha256": sha256_of(out["label"]),
           "overflow": int(out["overflow"]),
           "n_core": int(out["core"].sum()),
           "count_sha256": sha256_of(count),
           "n_nonempty": int((count[1:] > 0).sum()),
           "n_filtered": int(batch.count)}
    for key, value in got.items():
        require(value == JAX_GRID_ENGINE[key],
                f"cluster_grid {key} {value} != JAX CPU "
                f"{JAX_GRID_ENGINE[key]}")
    print(json.dumps({"phase": "cluster_grid", "card": card, **GRID_ENGINE,
                      **got, "jax_cpu_matches": True, "launches": launches,
                      "wall_s": wall}))


def icp_grid_phase(dev, card, kernels):
    """(c) Grid ICP against brute-force ICP through K3 at 100,000 target and
    source points (the Python loop of both, float32), and against the JAX
    CPU constants: in float64 (the plain versions, K3 being float32 only)
    to F64_ICP_GRID_TOL, so the loop, weights and composition are JAX's; in
    float32 R to JAX's float32 run and t to JAX's float64 answer. ``icp`` on
    the card (K3 + K5) is held to the same two JAX numbers. Returns the
    float32 grid ICP result."""
    import torch

    from tools.tier3_inputs import NN, nn_cell, nn_inputs
    from vtkcloudpoint_tpu_torch.config import ICPConfig
    from vtkcloudpoint_tpu_torch.kernels.neighbor import nn_cuda
    from vtkcloudpoint_tpu_torch.register.icp import icp, icp_loop
    from vtkcloudpoint_tpu_torch.register.nn_grid import (build_nn_grid,
                                                          icp_grid)

    src, tgt = (torch.from_numpy(a).to(dev) for a in nn_inputs())
    sv = torch.ones(src.shape[0], dtype=torch.bool, device=dev)
    tv = torch.ones(tgt.shape[0], dtype=torch.bool, device=dev)
    cfg = ICPConfig(max_iterations=NN["max_iterations"], tol=NN["tol"])
    cell = nn_cell(NN["m"])

    def grid_run():
        return icp_grid(src, sv, tgt, tv, cfg, cell_size=cell,
                        cell_cap=NN["cell_cap"],
                        fallback_cap=NN["fallback_cap"])

    def brute_run():
        # icp_grid's Python loop with K3's correspondences: its float32
        # solve, where icp on the card sums float64 moments (K5)
        def correspond(p):
            idx, d2 = nn_cuda(p, tgt, tv)
            return idx, d2, sv

        return icp_loop(src, sv, tgt, tv, cfg, None, None, correspond)

    build_ms = cuda_ms(lambda: build_nn_grid(tgt, tv, cell), 3)
    reset_launches()
    t0 = time.perf_counter()
    res, overflow = grid_run()
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    launches = read_launches()
    require(launches["nn_argmin"] > 0, "K3 did not launch in grid ICP")
    t0 = time.perf_counter()
    brute = brute_run()
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0

    r, t = res.r.cpu().numpy(), res.t.cpu().numpy()
    dr = float(np.abs(r - brute.r.cpu().numpy()).max())
    dt = float(np.abs(t - brute.t.cpu().numpy()).max())
    require(int(overflow) == JAX_ICP_GRID["overflow"] == 0,
            f"grid ICP unresolved overflow {int(overflow)}")
    require(dr <= ICP_GRID_TOL and dt <= ICP_GRID_TOL,
            f"grid ICP R, t differ from brute ICP by {dr}, {dt}")
    require(int(res.iterations) == JAX_ICP_GRID["icp_iterations"],
            f"grid ICP iterations {int(res.iterations)} != JAX CPU "
            f"{JAX_ICP_GRID['icp_iterations']}")

    def gap(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    t0 = time.perf_counter()
    res64, overflow64 = icp_grid(
        src.double(), sv, tgt.double(), tv, cfg, cell_size=cell,
        cell_cap=NN["cell_cap"], fallback_cap=NN["fallback_cap"],
        backend="torch")
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    ref64 = JAX_ICP_GRID_F64
    f64 = {"dR": gap(res64.r.cpu(), ref64["icp_r"]),
           "dt": gap(res64.t.cpu(), ref64["icp_t"])}
    require(int(overflow64) == 0
            and int(res64.iterations) == ref64["icp_iterations"]
            and max(f64.values()) <= F64_ICP_GRID_TOL,
            f"float64 grid ICP differs from JAX's float64 run: {f64}, "
            f"{int(res64.iterations)} iterations")
    jax = {"dR": gap(r, JAX_ICP_GRID["icp_r"]),
           "dt": gap(t, JAX_ICP_GRID["icp_t"]),
           "dt_f64": gap(t, ref64["icp_t"]),
           "jax_f32_dt_f64": gap(JAX_ICP_GRID["icp_t"], ref64["icp_t"])}
    require(jax["dR"] <= JAX_ICP_GRID_TOL
            and jax["dt_f64"] <= F32_ICP_GRID_T_TOL,
            f"grid ICP R, t far from the JAX CPU results: {jax}")
    on_card = icp(src, sv, tgt, tv, cfg)
    jax_card = {"dR": gap(on_card.r.cpu(), JAX_ICP_GRID["icp_r"]),
                "dt_f64": gap(on_card.t.cpu(), ref64["icp_t"]),
                "iterations": int(on_card.iterations)}
    require(jax_card["dR"] <= JAX_ICP_GRID_TOL
            and jax_card["dt_f64"] <= F32_ICP_GRID_T_TOL,
            f"icp on the card far from the JAX CPU results: {jax_card}")
    # grid ICP's float32 solve against icp's float64 moments: reported, not
    # held (PERF.md section 7)
    jax_card["max_abs_dR_grid"] = float((on_card.r - res.r).abs().max())
    jax_card["max_abs_dt_grid"] = float((on_card.t - res.t).abs().max())

    row = hold_k3(src[:NN["fallback_cap"]].contiguous(), tgt, tv,
                  "grid ICP fallback")
    add_fields(kernels, {"nn_argmin": {
        **row, "launches": launches["nn_argmin"]}}, "icp_grid")
    print(json.dumps({
        "phase": "icp_grid", "card": card, "m": NN["m"],
        "n_src": NN["n_src"], "cell": cell, "cell_cap": NN["cell_cap"],
        "fallback_cap": NN["fallback_cap"], "overflow": int(overflow),
        "iterations": int(res.iterations),
        "brute_iterations": int(brute.iterations),
        "max_abs_dR_brute": dr, "max_abs_dt_brute": dt,
        "max_abs_jax_f32": jax, "max_abs_jax_f64": f64,
        "card_icp_from_jax": jax_card,
        "icp_error": float(res.error), "launches": launches,
        "build_ms": build_ms, "grid_wall_s": grid_s,
        "brute_wall_s": brute_s, "f64_wall_s": f64_s}))
    return res


def halo_phase(inp, card):
    """(d) cluster_scan(halo_merge=True) on the tier-2 cloud through the
    kernels and with the plain versions, checked against the JAX CPU
    constants."""
    import torch

    from tools.tier3_inputs import HALO
    from vtkcloudpoint_tpu_torch.cluster.pipeline import cluster_scan

    def run(backend):
        return cluster_scan(
            inp.xyz, inp.motor, inp.valid, inp.cfg, mode="balanced",
            max_blocks=MAX_BLOCKS, quirks=False, noise_capacity=NOISE_CAP,
            max_clusters=MAX_CLUSTERS, cluster_capacity=CLUSTER_CAP,
            max_hull=MAX_HULL, halo_merge=True, halo_cap=HALO["halo_cap"],
            backend=backend)

    t0 = time.perf_counter()
    plain = run("torch")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    res = run("auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for name in ("dbscan_block", "cluster_shapes"):
        require(launches[name] > 0, f"kernel {name} did not launch in the "
                                    f"halo run")
    got = {"n_clusters": int(res.n_clusters),
           "label_sha256": sha256_of(res.label)}
    require(torch.equal(res.label, plain.label),
            "halo-union labels differ from the plain run")
    for key, value in got.items():
        require(value == JAX_HALO[key],
                f"halo {key} {value} != JAX CPU {JAX_HALO[key]}")
    require(int(res.block_overflow) == 0 and int(res.noise_overflow) == 0,
            "halo run overflowed")
    print(json.dumps({"phase": "halo_union", "card": card, **HALO, **got,
                      "jax_cpu_matches": True,
                      "labels_equal_plain_run": True,
                      "halo_points": MAX_BLOCKS * HALO["halo_cap"],
                      "launches": launches, "wall_s": wall,
                      "plain_wall_s": plain_s}))


def shape_variants_phase(s, card):
    """(e) cluster_shapes' plain variants -- candidate pruning, quickhull,
    the Elzinga-Hearn MEC -- on the card at K2's tier-2 inputs. Each equals
    the same variant on the CPU (the path the CPU tests hold to the JAX
    package) at rtol 2e-5. Against K2: pruning, where it overflowed
    nothing, gives K2's radius and area; quickhull gives K2's area where
    the wrap hull has fewer than max_hull vertices, and its radius
    differences there are printed (the pair/triple scan's float32
    containment test depends on the hull's vertex order, in the JAX
    package too); so is the E-H radius error."""
    from vtkcloudpoint_tpu_torch.ops.geometry import (cluster_shapes,
                                                      convex_hull,
                                                      hull_prune_pack)

    def shapes(both, bval, bcnt, **kw):
        return cluster_shapes(both, bval, bcnt, max_hull=MAX_HULL, **kw)

    def close(a, b):
        return (a - b).abs() <= SHAPES_ATOL + SHAPES_RTOL * b.abs()

    card_in = (s.both, s.bval, s.bcnt)
    cpu_in = tuple(t.cpu() for t in card_in)
    k2 = shapes(*card_in)
    variants = {"prune_cap": dict(prune_cap=PRUNE_CAP),
                "quick": dict(hull="quick"), "eh": dict(mec="eh")}
    reset_launches()
    out = {name: shapes(*card_in, **kw) for name, kw in variants.items()}
    launches = read_launches()
    for name, kw in variants.items():
        ref = shapes(*cpu_in, **kw)
        for key in ("center_x", "center_y", "radius", "rect_area"):
            ok = close(out[name][key].cpu(), ref[key])
            require(bool(ok.all()),
                    f"shapes {name} {key} on the card differs from the CPU "
                    f"at clusters {(~ok).nonzero()[:5].flatten().tolist()}")
    prune_ok = hull_prune_pack(s.both, s.bval, PRUNE_CAP)[2] == 0
    quick_ok = convex_hull(s.both, s.bval, MAX_HULL)[1].sum(dim=1) < MAX_HULL
    held = {"prune_cap": (prune_ok, ("radius", "rect_area")),
            "quick": (quick_ok, ("rect_area",))}
    for name, (mask, keys) in held.items():
        for key in keys:
            ok = close(out[name][key], k2[key]) | ~mask
            require(bool(ok.all()),
                    f"shapes {name} {key} differs from K2 at clusters "
                    f"{(~ok).nonzero()[:5].flatten().tolist()}")
    report = {}
    for name in variants:
        err = (out[name]["radius"] - k2["radius"]).abs()
        rel = err / k2["radius"].abs().clamp_min(1e-30)
        mask = held[name][0] if name in held else err >= 0
        differ = ~close(out[name]["radius"], k2["radius"]) & mask
        report[name] = {"compared": int(mask.sum()),
                        "radius_differs_from_k2": differ.nonzero()
                        .flatten().tolist()[:8],
                        "max_abs_err_radius": float(err[mask].max()),
                        "max_rel_err_radius": float(rel[mask].max()),
                        "ms": cuda_ms(lambda: shapes(*card_in, **variants[
                            name]), 1)}
    report["prune_cap"]["prune_overflow"] = int(
        out["prune_cap"]["prune_overflow"])
    print(json.dumps({"phase": "shape_variants", "card": card,
                      "shape": "K=%d cap=%d h=%d" % (*s.both.shape[:2],
                                                     MAX_HULL),
                      "equal_on_cpu": True, "k2_ms": cuda_ms(
                          lambda: shapes(*card_in), 5),
                      "launches": launches, **report}))


def _timed(fn):
    """(fn(), wall s, CUDA-event ms) of one call on the card."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def _scatter_points(label, pidx, n):
    """Block-layout labels back to point order (-1 slots dropped)."""
    import torch

    flat = torch.zeros(n, dtype=torch.int32, device=label.device)
    m = pidx >= 0
    flat[pidx[m].long()] = label[m]
    return flat


def sharded_phase(dev, card, kernels, t3, grid_icp, t4):
    """The multi-device entry points on a one-rank NCCL mesh (the world
    size torch.cuda.device_count() gives here: one card):
    (a) sharded_blocked_dbscan on the tier-3 job's 4,883 blocks (quirks
        off, halo off, 65,536 noise slots: the grid noise engine, as the
        job): labels in point order equal the job's, n_total and digest
        JAX's; overflows 0; K1 launches;
    (b) Engine.cluster_sharded on the Engine session (hier halo union,
        density-sized caps: tools/sharded_session.py) in each mode of
        sharded_session.MODES: overflows 0, n_total and the block-layout
        label digest equal JAX's; the default (hier) labels equal the
        port's single-device chain on the same blocks (K1, merge_blocks,
        halo_buffers, grid_union_ids); K1 launches;
    (c) sharded_icp of the tier-3 cluster centres onto its 5,120 truth
        points: R and t within SHARDED_ICP_TOL of the job's single-device
        ICP, the same iterations; K3 launches;
    (d) sharded_icp_grid at grid ICP's m = 100,000, nn="grid" and
        nn="brute" (K3): each within ICP_GRID_TOL of the other in R and
        F32_ICP_GRID_T_TOL in t, and of the single-device icp_grid; no
        overflow;
    (e) slam_pipeline_ba(mesh=...) on the tier-4 scans: float64 poses
        within F64_POSE_TOL of the single-device float64 run; float32
        (through K3) ATEs within the tier-4 phase's tolerance of JAX's
        float64 ATEs.
    Each part prints its wall time, CUDA-event time, K1/K3 launches and
    overflow counters."""
    import torch

    from tools.engine_session import SESSION, engine_config
    from tools.sharded_session import MODES, SHARDED
    from tools.tier3_inputs import NN, nn_cell, nn_inputs
    from vtkcloudpoint_tpu_torch.cluster.dbscan import dbscan_blocks_dispatch
    from vtkcloudpoint_tpu_torch.cluster.fusion import merge_blocks
    from vtkcloudpoint_tpu_torch.cluster.halo_fusion import (
        apply_halo_merge, grid_union_ids, halo_buffers)
    from vtkcloudpoint_tpu_torch.config import ICPConfig, ParallelConfig
    from vtkcloudpoint_tpu_torch.engine import Engine
    from vtkcloudpoint_tpu_torch.parallel.distributed import one_rank_group
    from vtkcloudpoint_tpu_torch.parallel.sharded import (
        sharded_blocked_dbscan, sharded_icp, sharded_icp_grid)

    world = torch.cuda.device_count()
    rows = {}

    def report(part, launches, **fields):
        print(json.dumps({"phase": "sharded_" + part, "card": card,
                          "world": 1, "backend": "nccl",
                          "launches": launches, **fields}))

    with one_rank_group(dev) as mesh:
        # (a) the tier-3 blocks
        inp3, s3 = t3
        T = inp3.T
        reset_launches()
        out, wall, ev = _timed(lambda: sharded_blocked_dbscan(
            mesh, s3.bc, s3.bv, T["eps"], T["min_pts"], T["metric"],
            quirks=False, noise_capacity_per_device=T["noise_cap"],
            noise_cell_cap=T["noise_cell_cap"]))
        launches = read_launches()
        require(launches["dbscan_block"] > 0,
                "K1 did not launch in sharded_blocked_dbscan")
        rows["a"] = launches
        label = _scatter_points(out["label"], s3.pidx, inp3.motor.shape[0])
        got = {"n_total": int(out["n_total"]),
               "label_sha256": sha256_of(label),
               "noise_overflow": int(out["noise_overflow"]),
               "halo_overflow": int(out["halo_overflow"])}
        require(got["noise_overflow"] == got["halo_overflow"] == 0,
                f"sharded tier-3 overflow: {got}")
        require(torch.equal(label, s3.fused["label"]),
                "sharded tier-3 labels differ from the tier-3 job's")
        require(got["n_total"] == JAX_TIER3["n_clusters"]
                and got["label_sha256"] == JAX_TIER3["label_sha256"],
                f"sharded tier-3 {got} differs from JAX CPU")
        report("tier3", launches, n_points=T["n_points"],
               blocks=T["max_blocks"], **got, equal_tier3_job=True,
               wall_s=wall, event_ms=ev)

        # (b) Engine.cluster_sharded on the Engine session
        sess = engine_session_inputs()
        eng = Engine(engine_config(), device=dev)
        batch = eng.filter_by_distance(
            eng.import_arrays(sess.motor, sess.rng,
                              capacity=SESSION["capacity"]),
            SESSION["dis_min"], SESSION["dis_max"])
        cap = eng.cfg.cluster.block_capacity
        caps = ParallelConfig.size_caps(
            eng.cfg.cluster.eps, SHARDED["density"], cap,
            blocks_per_device=-(-batch.capacity // cap), noise_frac=0.01)
        engine_out = {}
        for mode, kw in MODES.items():
            reset_launches()
            out, wall, ev = _timed(lambda: eng.cluster_sharded(
                batch, mesh=mesh, **SHARDED, **kw))
            launches = read_launches()
            require(launches["dbscan_block"] > 0,
                    f"K1 did not launch in Engine.cluster_sharded ({mode})")
            rows["b_" + mode] = launches
            got = {"n_total": int(out["n_total"]),
                   "label_sha256": sha256_of(out["label"]),
                   "noise_overflow": int(out["noise_overflow"]),
                   "halo_overflow": int(out["halo_overflow"])}
            require(got["noise_overflow"] == got["halo_overflow"] == 0,
                    f"Engine.cluster_sharded ({mode}) overflow: {got}")
            if mode in JAX_SHARDED:
                want = JAX_SHARDED[mode]
                require(got["n_total"] == want["n_total"]
                        and got["label_sha256"] == want["label_sha256"],
                        f"Engine.cluster_sharded ({mode}) {got} differs "
                        f"from JAX CPU {want}")
            engine_out[mode] = out
            report("engine_" + mode, launches, **got,
                   jax_cpu_matches=mode in JAX_SHARDED, wall_s=wall,
                   event_ms=ev, caps=caps)
        # the port's single-device chain on the same blocks
        from vtkcloudpoint_tpu_torch.cluster.blocks import (
            assign_blocks_balanced, gather_blocks_ordered)

        c = eng.cfg.cluster
        b = -(-batch.capacity // cap)
        part = assign_blocks_balanced(batch.motor, batch.valid, cap)
        bc, bv, pidx, _ = gather_blocks_ordered(batch.motor, part["order"],
                                                batch.valid, b, cap)
        db = dbscan_blocks_dispatch(bc, bv, c.eps, c.min_pts, c.metric)
        fused = merge_blocks(db["label"], bv, bc, pidx, batch.capacity,
                             c.eps, c.min_pts, c.metric, quirks=True,
                             noise_capacity=caps["noise_capacity"],
                             noise_cell_cap=caps["cell_cap"])
        glab = torch.where(pidx >= 0, fused["label"][pidx.clamp(0).long()],
                           0).to(torch.int32)
        hx, hlab, hval, hov = halo_buffers(bc, bv, glab, db["core"], c.eps,
                                           caps["halo_cap"])
        uni = grid_union_ids(hx, hlab, hval, fused["n_total"], c.eps,
                             c.metric, 4096, cell_cap=caps["cell_cap"],
                             max_rounds=ParallelConfig().fixpoint_max_rounds)
        single = apply_halo_merge(glab, uni["remap"])
        require(int(hov) == int(uni["overflow"]) == 0,
                "single-device halo chain overflowed")
        require(torch.equal(engine_out["hier"]["label"], single)
                and int(engine_out["hier"]["n_total"]) == int(
                    uni["n_after"]),
                "Engine.cluster_sharded labels differ from the single-device "
                "halo chain")
        require(torch.equal(engine_out["hier"]["point_index"], pidx),
                "Engine.cluster_sharded point_index differs")

        # (c) sharded_icp at tier 3's registration
        centers, cvalid = s3.stats["center3d"], s3.stats["count"] > 0
        icfg = ICPConfig(max_iterations=T["icp_iterations"])
        reset_launches()
        (r, t, d, it), wall, ev = _timed(lambda: sharded_icp(
            mesh, centers, cvalid, inp3.truth, inp3.truth_valid, icfg))
        launches = read_launches()
        require(launches["nn_argmin"] > 0, "K3 did not launch in sharded_icp")
        rows["c"] = launches
        dr = float((r - s3.reg.r).abs().max())
        dt = float((t - s3.reg.t).abs().max())
        require(dr <= SHARDED_ICP_TOL and dt <= SHARDED_ICP_TOL
                and int(it) == int(s3.reg.iterations),
                f"sharded_icp differs from icp: R {dr}, t {dt}, iterations "
                f"{int(it)} vs {int(s3.reg.iterations)}")
        report("icp", launches, n=centers.shape[0],
               m=inp3.truth.shape[0], iterations=int(it), max_abs_dR=dr,
               max_abs_dt=dt, error=float(d), wall_s=wall, event_ms=ev)

        # (d) sharded_icp_grid at grid ICP's size
        src, tgt = (torch.from_numpy(a).to(dev) for a in nn_inputs())
        sv = torch.ones(src.shape[0], dtype=torch.bool, device=dev)
        tv = torch.ones(tgt.shape[0], dtype=torch.bool, device=dev)
        gcfg = ICPConfig(max_iterations=NN["max_iterations"], tol=NN["tol"])
        grid_out = {}
        for nn in ("grid", "brute"):
            reset_launches()
            (r, t, d, it, ovf), wall, ev = _timed(lambda: sharded_icp_grid(
                mesh, src, sv, tgt, tv, gcfg, cell_size=nn_cell(NN["m"]),
                cell_cap=NN["cell_cap"], fallback_cap=NN["fallback_cap"],
                nn=nn))
            launches = read_launches()
            rows["d_" + nn] = launches
            dr = float((r - grid_icp.r).abs().max())
            dt = float((t - grid_icp.t).abs().max())
            require(int(ovf) == 0, f"sharded_icp_grid ({nn}) overflow "
                                   f"{int(ovf)}")
            require(dr <= JAX_ICP_GRID_TOL and dt <= F32_ICP_GRID_T_TOL,
                    f"sharded_icp_grid ({nn}) differs from icp_grid: R {dr}, "
                    f"t {dt}")
            grid_out[nn] = (r, t)
            report("icp_grid_" + nn, launches, m=NN["m"],
                   iterations=int(it), overflow=int(ovf), max_abs_dR=dr,
                   max_abs_dt=dt, error=float(d), wall_s=wall, event_ms=ev)
        require(rows["d_brute"]["nn_argmin"] > 0,
                "K3 did not launch in sharded_icp_grid(nn='brute')")
        # K3 at the brute path's shape (N = M = 100,000 a hop), held bit for
        # bit on its first iteration's query: the sources moved by the
        # centroid offset
        query = (src + (tgt.mean(dim=0) - src.mean(dim=0))).contiguous()
        add_fields(kernels, {"nn_argmin": hold_k3(query, tgt, tv,
                                                  "sharded brute")},
                   "sharded_brute")
        dr = float((grid_out["grid"][0] - grid_out["brute"][0]).abs().max())
        dt = float((grid_out["grid"][1] - grid_out["brute"][1]).abs().max())
        require(dr <= ICP_GRID_TOL and dt <= F32_ICP_GRID_T_TOL,
                f"sharded_icp_grid grid and brute differ: R {dr}, t {dt}")

        # (e) slam_pipeline_ba(mesh=...) on the tier-4 scans
        inp4 = t4.inp
        r64 = t4.ref["f64"]
        reset_launches()
        run, wall, ev = _timed(lambda: tier4_job(inp4, torch.float32,
                                                 mesh=mesh))
        launches = read_launches()
        require(launches["nn_argmin"] > 0,
                "K3 did not launch in slam_pipeline_ba(mesh=...)")
        rows["e"] = launches
        f32_dev = {k: abs(v - r64["slam"]["ate_" + k])
                   for k, v in run.ate.items()}
        require(max(f32_dev.values()) <= t4.f32_tol,
                f"sharded float32 ATEs {run.ate} far from JAX's float64 "
                f"(tolerance {t4.f32_tol})")
        f64, wall64, _ = _timed(lambda: tier4_job(inp4, torch.float64,
                                                  "torch", mesh=mesh))
        gaps = {k: max(float((tr.r - t4.f64.trajs[k].r).abs().max()),
                       float((tr.t - t4.f64.trajs[k].t).abs().max()))
                for k, tr in f64.trajs.items()}
        require(max(gaps.values()) <= F64_POSE_TOL,
                f"sharded float64 poses differ from the single-device run: "
                f"{gaps}")
        report("slam_ba", launches, ate_f32=run.ate,
               f32_ate_dev_from_jax_f64=f32_dev, f32_ate_tol=t4.f32_tol,
               f64_pose_gap_single=gaps, n_landmarks=int(
                   run.stats["n_landmarks"]), wall_s=wall, event_ms=ev,
               f64_wall_s=wall64)

    add_fields(kernels, {
        "dbscan_block": {"launches": {k: v["dbscan_block"]
                                      for k, v in rows.items()}},
        "nn_argmin": {"launches": {k: v["nn_argmin"]
                                   for k, v in rows.items()}}}, "sharded")
    print(json.dumps({"phase": "sharded", "card": card, "world": 1,
                      "cards": world, "backend": "nccl",
                      "not_exercised_across_ranks": [
                          "all_gather", "all_to_all", "ppermute_ring",
                          "psum", "pmin", "pmax"]}))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vtkcloudpoint_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = card_name()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- build ----
    t0 = time.perf_counter()
    build.load()
    print(json.dumps({"phase": "build",
                      "seconds": round(time.perf_counter() - t0, 3),
                      "nvcc_seconds": build.build_info.get("seconds"),
                      "cached": build.build_info.get("cached")}))
    for line in build.build_info.get("ptxas", "").splitlines():
        if "registers" in line:
            print("ptxas:", line.strip())

    # ---- the job with the plain versions on the card (the reference) ----
    inp = tier2_inputs(dev)
    t0 = time.perf_counter()
    plain_res, plain_reg = tier2_job(inp, "torch")
    torch.cuda.synchronize()
    print(json.dumps({"phase": "plain_job",
                      "seconds": round(time.perf_counter() - t0, 3),
                      "n_clusters": int(plain_res.n_clusters)}))

    # ---- each kernel against its plain version, at the job's shapes ----
    _, s = tier2_stages(inp)
    rows = {"dbscan_block": hold_k1(s.bc, s.bv, EPS, MIN_PTS, "tier 2"),
            "cluster_shapes": hold_k2(s.both, s.bval, MAX_HULL, "tier 2"),
            "nn_argmin": hold_k3(first_icp_query(s.stats, inp.truth),
                                 inp.truth, inp.truth_valid, "tier 2"),
            "icp_step": hold_k5(s.stats["center3d"], s.stats["count"] > 0,
                                inp.truth, inp.truth_valid, inp.icfg,
                                "tier 2")}
    mods = kernel_modules()
    kernels = [{"name": name, "route": "cuda", "source": mods[name].SOURCE,
                "replaces": mods[name].REPLACES, **row}
               for name, row in rows.items()]
    # K2 at the Engine's max_hull on the same tier-2 tables: its time must
    # follow the hull sizes, not max_hull
    add_fields(kernels, {"cluster_shapes": hold_k2(
        s.both, s.bval, ENGINE_MAX_HULL, "tier 2, h 64")}, "tier2_h64")
    print(json.dumps({"phase": "kernel_checks", "ok": True,
                      **{name: row["shape"] for name, row in rows.items()}}))

    # ---- the main path through the kernels ----
    reset_launches()
    t0 = time.perf_counter()
    res, reg = tier2_job(inp, "auto")
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    launches = read_launches()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        require(k["launches"] > 0,
                f"kernel {k['name']} did not launch on the main path")

    digest = sha256_of(res.label)
    n_clusters = int(res.n_clusters)
    require(int(res.block_overflow) == 0, "block overflow")
    require(int(res.noise_overflow) == 0, "noise overflow")
    require(n_clusters <= MAX_CLUSTERS,
            f"n_clusters {n_clusters} > {MAX_CLUSTERS}")
    require(torch.equal(res.label, plain_res.label),
            "labels differ from the plain-version run on the card")
    require(n_clusters == int(plain_res.n_clusters),
            "n_clusters differs from the plain-version run")
    require(n_clusters == JAX_N_CLUSTERS,
            f"n_clusters {n_clusters} != JAX CPU {JAX_N_CLUSTERS}")
    require(digest == JAX_LABEL_SHA256,
            f"label digest {digest} != JAX CPU {JAX_LABEL_SHA256}")
    r = reg.r.cpu().numpy()
    t = reg.t.cpu().numpy()
    require(np.isfinite(r).all() and np.isfinite(t).all(),
            "ICP result not finite")
    require(np.allclose(r, plain_reg.r.cpu().numpy(), atol=1e-5)
            and np.allclose(t, plain_reg.t.cpu().numpy(), atol=1e-5),
            "ICP R, t differ from the plain-version run")
    require(np.allclose(r.T @ r, np.eye(3), atol=1e-5),
            "ICP R is not a rotation")
    require(np.allclose(t, JAX_ICP_T, atol=1e-4),
            f"ICP t {t.tolist()} far from the JAX CPU result {JAX_ICP_T}")
    radii = res.radius3d[res.count > 3]
    require(bool(torch.isfinite(radii).all()) and bool((radii > 0).all()),
            "cluster radii not finite and positive")
    print(json.dumps({
        "phase": "tier2_job", "n_points": N_POINTS,
        "n_clusters": n_clusters, "jax_cpu_n_clusters": JAX_N_CLUSTERS,
        "tpu_record_n_clusters": TPU_RECORD_N_CLUSTERS,
        "label_sha256": digest, "label_sha256_matches_jax_cpu": True,
        "labels_equal_plain_run": True,
        "block_overflow": int(res.block_overflow),
        "noise_overflow": int(res.noise_overflow),
        "icp_error": float(reg.error), "jax_cpu_icp_error": JAX_ICP_ERROR,
        "icp_iterations": int(reg.iterations),
        "icp_r": r.tolist(), "icp_t": t.tolist(),
        "first_run_seconds": job_s}))

    # ---- per-stage times (CUDA events, after a warm-up) ----
    stages, _ = tier2_stages(inp)
    per_stage = {name: cuda_ms(fn, 5) for name, fn in stages.items()}
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        tier2_job(inp)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"phase": "per_stage_ms", "card": card, **per_stage,
                      "sum": sum(per_stage.values()),
                      "job_wall_ms": walls}))

    # ---- K4 on its own entry point; the Engine session ----
    kernels.append(radius_phase(inp, s, s.db["core"], card))
    engine_phase(dev, card, kernels)

    # ---- the tier-3 paths: grid engines, halo union, shape variants ----
    shape_variants_phase(s, card)
    halo_phase(inp, card)
    grid_engine_phase(dev, card)
    grid_icp = icp_grid_phase(dev, card, kernels)
    t3 = tier3_phase(dev, card, kernels)

    # ---- the tier-4 SLAM job and scan-to-map ----
    t4 = tier4_phase(dev, card, kernels)

    # ---- the multi-device paths on a one-rank NCCL group ----
    sharded_phase(dev, card, kernels, t3, grid_icp, t4)

    require("jax" not in sys.modules, "jax was imported")
    jax_package = sorted(m for m in sys.modules if m == "vtkcloudpoint_tpu"
                         or m.startswith("vtkcloudpoint_tpu."))
    require(not jax_package, f"the JAX package was imported: {jax_package}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
