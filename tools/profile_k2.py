"""Where the time of K2 (cluster shapes) goes on one GPU, and K4's (radius
count) time per metric.

    python3 tools/profile_k2.py [--reps 20]

K2: builds a diagnostic library from the same source as the kernel library
(kernels/csrc/shapes.cu) with the macro VTKCP_K2_PROFILE, under which every
cluster's first thread writes clock64() at its start and after each phase,
its hull size and its valid count into an int64 [K, 8] buffer. The kernel
library never has the macro. Runs that build on K2's tables of the tier-2
job (K = 2,048) at max_hull 32 and 64 (and its first 512), of the Engine
session (max_hull 64), of the tier-3 job (K = 24,576) and on rings whose
hulls all reach max_hull, and prints for each, as JSON lines:

  phase_cycles   mean SM cycles per cluster in each phase, and their shares
                 (load, wrap, MEC pairs, MEC triples, rectangle);
  phase_ms       the kernel library's CUDA-event time split by those shares;
  hull           hull size mean, p99 and max; valid points per cluster;
  worst          the three slowest clusters, phase by phase;
and the kernel library's time beside the diagnostic build's (the cost of
the clocks). The diagnostic build's output must equal the kernel library's.
A second diagnostic build (macro VTKCP_K2_LOAD_ONLY) stops every cluster
after its load and compaction: its time is the most that overlapping the
load with the shaping could hide. At each shape it also times the kernel
library (its own choice of warps a cluster) against diagnostic builds that
fix 1, 2 and 4 warps a cluster (macro VTKCP_K2_GROUP), in turns; every
build's output must equal the kernel library's.

K4: times radius_count_cuda at N = 500,000 (the tier-2 cloud) for each
metric: l1_motor on the motor coordinates, D = 2; l2_xyz on XYZ, D = 3;
signed_sum_xy on the motor coordinates with a negative eps.
"""
import argparse
import concurrent.futures
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

PHASES = ("load", "wrap", "mec_pairs", "mec_triples", "rect")
SLOTS = 8
GROUPS = (1, 2, 4)


def diagnostic_libraries():
    """The clock64 build, the load-only build and one build a fixed
    warps-a-cluster of GROUPS, compiled together: (profile library,
    load-only library, {G: library})."""
    from vtkcloudpoint_tpu_torch.kernels import build

    sigs = {k: v for k, v in build.SIGNATURES.items()
            if k.startswith("vtkcp_shapes") or k == "vtkcp_cluster_shapes"}
    builds = {"profile": (("VTKCP_K2_PROFILE",), "libvtkcp_k2_profile"),
              "load": (("VTKCP_K2_LOAD_ONLY",), "libvtkcp_k2_load")}
    for g in GROUPS:
        builds[g] = ((f"VTKCP_K2_GROUP={g}",), f"libvtkcp_k2_group{g}")
    # dbscan_block.cu carries vtkcp_error_string, which open_library binds
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        paths = dict(zip(builds, pool.map(
            lambda b: build.build(("shapes.cu", "dbscan_block.cu"), *b),
            builds.values())))
    prof = build.open_library(paths.pop("profile"), {
        **sigs, "vtkcp_k2_profile_buffer": (build._P,)})
    load = build.open_library(paths.pop("load"), sigs)
    return prof, load, {g: build.open_library(p, sigs)
                        for g, p in paths.items()}


def launch(lib, points, valid, max_hull):
    """``vtkcp_cluster_shapes`` of a diagnostic library ``lib`` on inputs
    that shapes_cuda has accepted: out f32 [K, 6]."""
    import torch

    from vtkcloudpoint_tpu_torch.kernels import build

    K, cap, _ = points.shape
    out = torch.empty((K, 6), dtype=torch.float32, device=points.device)
    build.check(lib.vtkcp_cluster_shapes(
        points.data_ptr(), valid.data_ptr(), K, cap, max_hull,
        out.data_ptr(), build.stream_handle(points.device)),
        "vtkcp_cluster_shapes")
    return out


def tier_tables(inp):
    """K2's input of a job (tier 2 or tier 3): both coordinate systems'
    tables, [2 max_clusters, cap, 2] and their validity."""
    stages, s = chip_smoke.job_stages(inp)
    for name in ("partition_gather", "dbscan", "fusion", "stats", "bucket"):
        stages[name]()
    return s.both, s.bval


def engine_tables(dev):
    """K2's input of the Engine session, as chip_smoke.engine_phase builds
    it."""
    import torch

    from tools.engine_session import SESSION, engine_config
    from vtkcloudpoint_tpu_torch.engine import Engine
    from vtkcloudpoint_tpu_torch.ops.segment import bucket_payload_by_cluster

    sess = chip_smoke.engine_session_inputs()
    eng = Engine(engine_config(), device=dev)
    batch = eng.filter_by_distance(
        eng.import_arrays(sess.motor, sess.rng, capacity=SESSION["capacity"]),
        SESSION["dis_min"], SESSION["dis_max"])
    res = eng.cluster(batch, **SESSION["cluster"])
    pay = (batch.xyz[:, 0], batch.xyz[:, 1], batch.motor[:, 0],
           batch.motor[:, 1])
    tabs, tval, _, _ = bucket_payload_by_cluster(
        res.label, batch.valid, pay, chip_smoke.MAX_CLUSTERS,
        chip_smoke.CLUSTER_CAP)
    return (torch.cat([tabs[..., 0:2], tabs[..., 2:4]]).contiguous(),
            torch.cat([tval, tval]))


def ring_tables(dev, K=2048, cap=1024, ring=200):
    """Worst case: every cluster a ring of ``ring`` points (its hull
    reaches any max_hull up to ``ring``) around a few interior points,
    slots scattered."""
    import torch

    rng = np.random.default_rng(5)
    points = np.zeros((K, cap, 2), np.float32)
    valid = np.zeros((K, cap), bool)
    for k in range(K):
        a = rng.uniform(0, 2 * np.pi, ring)
        pts = np.concatenate([
            rng.uniform(0, 50, 2) + np.stack([np.cos(a), np.sin(a)], -1),
            rng.uniform(0, 50, 2) + 0.1 * rng.standard_normal((300, 2))])
        slots = np.sort(rng.choice(cap, len(pts), replace=False))
        points[k, slots] = pts
        valid[k, slots] = True
    return (torch.from_numpy(points).to(dev), torch.from_numpy(valid).to(dev))


def split(name, points, valid, max_hull, libs, reps, card):
    import torch

    from vtkcloudpoint_tpu_torch.kernels import build
    from vtkcloudpoint_tpu_torch.kernels import shapes as k_shapes

    lib, load_lib, group_libs = libs
    K, cap, _ = points.shape
    prof = torch.zeros((K, SLOTS), dtype=torch.int64, device=points.device)
    build.check(lib.vtkcp_k2_profile_buffer(prof.data_ptr()),
                "vtkcp_k2_profile_buffer")
    prod = torch.stack(k_shapes.shapes_cuda(points, valid, max_hull), 1)
    diag = launch(lib, points, valid, max_hull)
    torch.cuda.synchronize()
    chip_smoke.require(torch.equal(diag, prod),
                       f"diagnostic K2 differs ({name})")
    clocks = prof.cpu().numpy()
    cycles = (clocks[:, 1:len(PHASES) + 1]
              - clocks[:, :len(PHASES)]).astype(float)
    chip_smoke.require(bool((cycles >= 0).all()), "phase clocks not ordered")
    mean = cycles.mean(axis=0)
    share = mean / mean.sum()
    ms = chip_smoke.cuda_ms(lambda: k_shapes.shapes_cuda(
        points, valid, max_hull), reps)
    diag_ms = chip_smoke.cuda_ms(lambda: launch(lib, points, valid,
                                                max_hull), reps)
    nh, nv = clocks[:, 6], clocks[:, 7]
    worst = np.argsort(cycles.sum(axis=1))[::-1][:3]
    print(json.dumps({
        "k2_split": name, "card": card,
        "shape": f"K={K} cap={cap} h={max_hull}",
        "ms": ms, "diagnostic_ms": diag_ms,
        "load_only_ms": chip_smoke.cuda_ms(lambda: launch(
            load_lib, points, valid, max_hull), reps),
        "phase_cycles": dict(zip(PHASES, mean.tolist())),
        "phase_share": dict(zip(PHASES, share.round(4).tolist())),
        "phase_ms": dict(zip(PHASES, (share * ms).tolist())),
        "cluster_cycles_mean": float(cycles.sum(axis=1).mean()),
        "cluster_cycles_max": float(cycles.sum(axis=1).max()),
        "hull": {"mean": float(nh.mean()),
                 "p99": float(np.percentile(nh, 99)),
                 "max": int(nh.max()),
                 "at_max_hull": int((nh == max_hull).sum())},
        "valid": {"mean": float(nv.mean()), "max": int(nv.max()),
                  "empty": int((nv == 0).sum())},
        "worst": [{"cluster": int(w), "phase_cycles": cycles[w].tolist(),
                   "hull": int(nh[w]), "valid": int(nv[w])} for w in worst],
        "group_chosen": build.load().vtkcp_shapes_group(K, cap, max_hull),
        "group_ms": group_sweep(points, valid, max_hull, prod, group_libs,
                                reps),
        "smem_bytes_per_cluster": lib.vtkcp_shapes_smem_bytes(cap,
                                                              max_hull)}))


def group_sweep(points, valid, max_hull, prod, group_libs, reps):
    """CUDA-event ms of the kernel library ("auto") and of each fixed
    warps-a-cluster build of ``group_libs``, forward then backward; each
    output must equal ``prod``."""
    import torch

    from vtkcloudpoint_tpu_torch.kernels import shapes as k_shapes

    runs = {"auto": lambda: torch.stack(k_shapes.shapes_cuda(
        points, valid, max_hull), 1)}
    for g, lib in group_libs.items():
        runs[str(g)] = (lambda lib=lib: launch(lib, points, valid, max_hull))
    times = {}
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            chip_smoke.require(torch.equal(runs[key](), prod),
                               f"K2 with {key} warps a cluster differs")
            times.setdefault(key, []).append(chip_smoke.cuda_ms(runs[key],
                                                                reps))
    return times


def k4_metrics(inp, card, reps):
    """K4 per metric at N = 500,000."""
    from vtkcloudpoint_tpu_torch.kernels import neighbor as k_nn

    xy = inp.motor
    cases = {"l1_motor": (xy, chip_smoke.EPS),
             "l2_xyz": (inp.xyz, chip_smoke.EPS),
             "signed_sum_xy": (xy, -0.5)}
    for metric, (coords, eps) in cases.items():
        valid = inp.valid
        n, d = coords.shape
        ref = k_nn.radius_count_cuda(coords, valid, eps, metric)
        ms = chip_smoke.cuda_ms(lambda: k_nn.radius_count_cuda(
            coords, valid, eps, metric), reps)
        nv = float(valid.sum())
        pairs = nv * (nv - 1) / 2
        print(json.dumps({
            "k4": metric, "card": card, "n": n, "d": d, "eps": eps,
            "median_count": float(ref.float().median()), "ms": ms,
            "pairs": pairs, "ms_per_1e9_pairs": ms / pairs * 1e9}))


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_k2: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_name()
    print(card)
    dev = torch.device("cuda", 0)
    libs = diagnostic_libraries()
    inp = chip_smoke.tier2_inputs(dev)
    both, bval = tier_tables(inp)
    split("tier2_h32", both, bval, 32, libs, args.reps, card)
    split("tier2_h64", both, bval, 64, libs, args.reps, card)
    split("tier2_k512_h32", both[:512].contiguous(),
          bval[:512].contiguous(), 32, libs, args.reps, card)
    k4_metrics(inp, card, max(1, args.reps // 10))
    both, bval = engine_tables(dev)
    split("engine_h64", both, bval, 64, libs, args.reps, card)
    rp, rv = ring_tables(dev)
    split("rings_h32", rp, rv, 32, libs, args.reps, card)
    split("rings_h64", rp, rv, 64, libs, args.reps, card)
    del inp, both, bval, rp, rv
    torch.cuda.empty_cache()
    both, bval = tier_tables(chip_smoke.tier3_inputs(dev))
    split("tier3_h32", both, bval, 32, libs, args.reps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
