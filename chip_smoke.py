"""Smoke run of the PyTorch/CUDA port (vtkcloudpoint_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit);
2. builds the hand-written kernels from kernels/csrc/ (nvcc, sm_90a);
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the tier-2 job below, and times both with CUDA events;
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
   through its own entry point (kernels.neighbor.radius_count);
7. runs the Engine session of tools/engine_session.py (500k points:
   import, distance filter, cluster with max_hull 64, radius rejection,
   registration single-start, multi-start and RANSAC, match, export)
   through the kernels and again with the plain versions on the card, holds
   the two runs equal and the single-start run to the JAX package's float32
   CPU result (tools/jax_reference_engine.py), and holds K2 at h = 64
   against its plain version at the session's shapes;
8. prints a JSON line describing every kernel, and last
   {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA device it exits with 1 at once. Of the JAX
package it loads only its numpy-only modules (config, io/loaders,
viz/vtkio), never JAX.
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
ENGINE_STEPS = ("import", "filter", "cluster", "reject", "register",
                "register_multistart", "register_ransac", "match", "export")
ENGINE_MAX_HULL = 64            # Engine.cluster leaves cluster_scan's default
RADIUS_SESSION_ROWS = 65_536
RADIUS_L2_EPS = 0.002           # metres; median count ~ a few hundred
RADIUS_SIGNED_TARGET = 200      # the signed-sum eps puts the median here
RADIUS_SAMPLE = 16_384
RADIUS_FULL_PLAIN_S = 20.0


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


def tier2_inputs(dev):
    """The bench cloud (bench.synthetic_cloud, seed 0) and configs on dev."""
    import torch

    sys.path.insert(0, ROOT)
    import bench  # numpy only at module level: the cloud generator
    from vtkcloudpoint_tpu.config import ClusterConfig, EngineConfig, ICPConfig

    motor, xyz, truth = bench.synthetic_cloud(N_POINTS)
    return SimpleNamespace(
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


def tier2_stages(inp, backend="auto"):
    """The job's stages as separate calls on fixed inputs, bench.py's stage
    names -> zero-argument callables (intermediates computed once here)."""
    import torch

    from vtkcloudpoint_tpu_torch.cluster.blocks import (
        partition_gather_sorted)
    from vtkcloudpoint_tpu_torch.cluster.dbscan import dbscan_blocks_dispatch
    from vtkcloudpoint_tpu_torch.cluster.fusion import merge_blocks
    from vtkcloudpoint_tpu_torch.ops.geometry import cluster_shapes
    from vtkcloudpoint_tpu_torch.ops.segment import (
        bucket_payload_by_cluster, cluster_stats)
    from vtkcloudpoint_tpu_torch.register.icp import icp

    s = SimpleNamespace()

    def partition():
        return partition_gather_sorted(inp.motor, inp.valid, BLOCK_CAP,
                                       MAX_BLOCKS)

    def dbscan():
        return dbscan_blocks_dispatch(s.bc, s.bv, EPS, MIN_PTS,
                                      backend=backend)

    def fusion():
        return merge_blocks(s.db["label"], s.bv, s.bc, s.pidx, N_POINTS,
                            EPS, MIN_PTS, quirks=False,
                            noise_capacity=NOISE_CAP)

    def stats():
        return cluster_stats(inp.xyz, inp.motor, s.label, inp.valid,
                             MAX_CLUSTERS)

    def bucket():
        pay = (inp.xyz[:, 0], inp.xyz[:, 1], inp.motor[:, 0],
               inp.motor[:, 1])
        return bucket_payload_by_cluster(s.label, inp.valid, pay,
                                         MAX_CLUSTERS, CLUSTER_CAP)

    def shapes_x2():
        return cluster_shapes(s.both, s.bval, s.bcnt, max_hull=MAX_HULL,
                              backend=backend)

    def icp_stage():
        return icp(s.stats["center3d"], s.stats["count"] > 0, inp.truth,
                   inp.truth_valid, inp.icfg, chunk=1024, backend=backend)

    s.bc, s.bv, s.pidx, _ = partition()
    s.db = dbscan()
    s.label = fusion()["label"]
    s.stats = stats()
    tabs, tval, runs, _ = bucket()
    s.both = torch.cat([tabs[..., 0:2], tabs[..., 2:4]], dim=0).contiguous()
    s.bval = torch.cat([tval, tval])
    s.bcnt = torch.cat([runs, runs])
    fns = (partition, dbscan, fusion, stats, bucket, shapes_x2, icp_stage)
    return dict(zip(STAGES, fns)), s


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
    print(json.dumps({"phase": "radius_count", "card": card,
                      "launches": launches, "blocks_equal_k1_core": 16,
                      **report}))
    a = report["a_l1_motor_500k"]
    return {"name": "radius_count", "route": "cuda",
            "source": k_nn.RADIUS_SOURCE, "replaces": k_nn.RADIUS_REPLACES,
            "launches": launches, "max_abs_err": err, "ms": a["ms"],
            "plain_ms": a["plain_ms"]}


def engine_phase(dev, card, kernels):
    """The Engine session through the kernels and with the plain versions,
    checked against each other and the JAX constants; K2 at h = 64 against
    its plain version at the session's shapes."""
    import torch

    from vtkcloudpoint_tpu_torch.kernels import dbscan as k_dbscan
    from vtkcloudpoint_tpu_torch.kernels import neighbor as k_nn
    from vtkcloudpoint_tpu_torch.kernels import shapes as k_shapes
    from vtkcloudpoint_tpu_torch.ops.segment import bucket_payload_by_cluster

    sess = engine_session_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "plain"))
        os.makedirs(os.path.join(tmp, "cuda"))
        t0 = time.perf_counter()
        plain = engine_run(sess, dev, "torch", os.path.join(tmp, "plain"))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0

        mods = {"dbscan_block": k_dbscan, "cluster_shapes": k_shapes,
                "nn_argmin": k_nn}
        for mod in mods.values():
            mod.launches = 0
        timer = StepTimer()
        run = engine_run(sess, dev, "auto", os.path.join(tmp, "cuda"),
                         timer)
        torch.cuda.synchronize()
        launches = {name: mod.launches for name, mod in mods.items()}
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

    label = res.label.cpu().numpy().astype(np.int32)
    digest = hashlib.sha256(label.tobytes()).hexdigest()
    got = {"n_clusters": int(res.n_clusters), "label_sha256": digest,
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
    kout = k_shapes.shapes_cuda(both, bval, ENGINE_MAX_HULL)
    pout = k_shapes.shapes_plain(both, bval, ENGINE_MAX_HULL)
    err = 0.0
    for name, x, y in zip(("center_x", "center_y", "radius", "len_long",
                           "len_short", "area"), kout, pout):
        bad = (x - y).abs() > SHAPES_ATOL + SHAPES_RTOL * y.abs()
        require(not bool(bad.any()),
                f"K2 h=64 {name} differs from the plain version at "
                f"clusters {bad.nonzero()[:5].flatten().tolist()}")
        err = max(err, float((x - y).abs().max()))
    k2 = next(k for k in kernels if k["name"] == "cluster_shapes")
    k2.update(max_abs_err_h64=err,
              ms_h64=cuda_ms(lambda: k_shapes.shapes_cuda(
                  both, bval, ENGINE_MAX_HULL), 20),
              plain_ms_h64=cuda_ms(lambda: k_shapes.shapes_plain(
                  both, bval, ENGINE_MAX_HULL), 3))
    for k in kernels:
        if k["name"] in launches:
            k["launches_engine"] = launches[k["name"]]

    print(json.dumps({
        "phase": "engine", "card": card, "n_points": len(sess.rng),
        "n_filtered": int(b.count), **got, "jax_cpu_matches": True,
        "labels_equal_plain_run": True,
        "block_overflow": int(res.block_overflow),
        "noise_overflow": int(res.noise_overflow),
        "launches": launches, "max_hull": ENGINE_MAX_HULL,
        "k2_h64": f"K={both.shape[0]} cap={both.shape[1]}",
        "rmse": float(run.match["rmse"]), **regs,
        "plain_run_seconds": plain_s}))
    print(json.dumps({"phase": "engine_step_ms", "card": card,
                      "wall_ms": timer.wall, "event_ms": timer.device,
                      "wall_sum": sum(timer.wall.values())}))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vtkcloudpoint_tpu_torch.cluster.dbscan import dbscan_blocks
    from vtkcloudpoint_tpu_torch.kernels import build
    from vtkcloudpoint_tpu_torch.kernels import dbscan as k_dbscan
    from vtkcloudpoint_tpu_torch.kernels import neighbor as k_nn
    from vtkcloudpoint_tpu_torch.kernels import shapes as k_shapes

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
    kernels = []
    kout = k_dbscan.dbscan_blocks_cuda(s.bc, s.bv, EPS, MIN_PTS)
    pout = dbscan_blocks(s.bc, s.bv, EPS, MIN_PTS)
    for key in ("label", "n_clusters", "core"):
        require(torch.equal(kout[key], pout[key]),
                f"K1 {key} differs from the plain version")
    k1_core = kout["core"]
    kernels.append({
        "name": "dbscan_block", "route": "cuda", "source": k_dbscan.SOURCE,
        "replaces": k_dbscan.REPLACES,
        "max_abs_err": float((kout["label"] - pout["label"]).abs().max()),
        "ms": cuda_ms(lambda: k_dbscan.dbscan_blocks_cuda(
            s.bc, s.bv, EPS, MIN_PTS), 20),
        "plain_ms": cuda_ms(lambda: dbscan_blocks(s.bc, s.bv, EPS, MIN_PTS),
                            3),
    })

    kout = k_shapes.shapes_cuda(s.both, s.bval, MAX_HULL)
    pout = k_shapes.shapes_plain(s.both, s.bval, MAX_HULL)
    names = ("center_x", "center_y", "radius", "len_long", "len_short",
             "area")
    err = 0.0
    for name, a, b in zip(names, kout, pout):
        bad = (a - b).abs() > SHAPES_ATOL + SHAPES_RTOL * b.abs()
        require(not bool(bad.any()),
                f"K2 {name} differs from the plain version at clusters "
                f"{bad.nonzero()[:5].flatten().tolist()}")
        err = max(err, float((a - b).abs().max()))
    kernels.append({
        "name": "cluster_shapes", "route": "cuda",
        "source": k_shapes.SOURCE, "replaces": k_shapes.REPLACES,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: k_shapes.shapes_cuda(s.both, s.bval,
                                                   MAX_HULL), 20),
        "plain_ms": cuda_ms(lambda: k_shapes.shapes_plain(s.both, s.bval,
                                                          MAX_HULL), 3),
    })

    # the first ICP correspondence: centres moved by the centroid offset
    w = (s.stats["count"] > 0).float()
    centers = s.stats["center3d"]
    query = (centers + inp.truth.mean(dim=0) - (centers * w[:, None]).sum(
        dim=0) / w.sum().clamp_min(1.0)).contiguous()
    args = (query, inp.truth, inp.truth_valid)
    kidx, kd2 = k_nn.nn_cuda(*args)
    pidx, pd2 = k_nn.nn_plain(*args, 1024)
    require(torch.equal(kidx, pidx), "K3 idx differs from the plain version")
    require(torch.equal(kd2, pd2), "K3 d2 differs from the plain version")
    kernels.append({
        "name": "nn_argmin", "route": "cuda", "source": k_nn.SOURCE,
        "replaces": k_nn.REPLACES,
        "max_abs_err": float((kd2 - pd2).abs().max()),
        "ms": cuda_ms(lambda: k_nn.nn_cuda(*args), 100),
        "plain_ms": cuda_ms(lambda: k_nn.nn_plain(*args, 1024), 100),
    })
    print(json.dumps({
        "phase": "kernel_checks", "ok": True,
        "dbscan_block": "B=%d cap=%d D=%d" % tuple(s.bc.shape),
        "cluster_shapes": "K=%d cap=%d h=%d" % (*s.both.shape[:2], MAX_HULL),
        "nn_argmin": "N=%d M=%d" % (query.shape[0], inp.truth.shape[0])}))

    # ---- the main path through the kernels ----
    modules = {"dbscan_block": k_dbscan, "cluster_shapes": k_shapes,
               "nn_argmin": k_nn}
    for mod in modules.values():
        mod.launches = 0
    t0 = time.perf_counter()
    res, reg = tier2_job(inp, "auto")
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    for k in kernels:
        k["launches"] = modules[k["name"]].launches
        require(k["launches"] > 0,
                f"kernel {k['name']} did not launch on the main path")

    label = res.label.cpu().numpy().astype(np.int32)
    digest = hashlib.sha256(label.tobytes()).hexdigest()
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
    kernels.append(radius_phase(inp, s, k1_core, card))
    engine_phase(dev, card, kernels)

    require("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
