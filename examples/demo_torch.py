"""End-to-end demo of the PyTorch port: the workflow of examples/demo.py,
headless, through vtkcloudpoint_tpu_torch's Engine.

Writes the same synthetic scanner session (examples/demo.py: make_session),
then runs import -> distance filter -> blocked DBSCAN + fusion -> radius
rejection -> coarse alignment -> ICP -> threshold matching -> exports (txt +
.vtk scene), and prints the same lines as examples/demo.py; each Engine
step's time, from the port's span recorder, goes to standard error.

    python examples/demo_torch.py [--device cpu|cuda] [outdir]

``--device cuda`` (the default) runs the hand-written kernels and fails if
no CUDA device is present; ``--device cpu`` runs their plain versions.
"""
import argparse
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default=None)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain versions)")
    outdir = args.outdir or tempfile.mkdtemp(prefix="vtkcloudpoint_demo_")
    os.makedirs(outdir, exist_ok=True)

    sys.path.insert(0, HERE)
    from demo import make_session   # numpy only: the JAX demo's generator
    from vtkcloudpoint_tpu_torch.config import (ClusterConfig, EngineConfig,
                                                FilterConfig, ICPConfig)
    from vtkcloudpoint_tpu_torch.engine import Engine
    from vtkcloudpoint_tpu_torch.utils import profiling

    centers_truth = make_session(outdir)
    cfg = EngineConfig(
        cluster=ClusterConfig(eps=0.12, min_pts=10, pts_in_cell=128),
        filters=FilterConfig(dis_min=10.0, dis_max=100.0),
        icp=ICPConfig(max_iterations=80, match_distance=1.0),
    )
    eng = Engine(cfg, device=args.device)

    with profiling.recording() as rec:
        batch, names = eng.import_folder(outdir)
        batch = eng.filter_by_distance(batch, 10.0, 100.0)
        res = eng.cluster(batch, max_clusters=256, cluster_capacity=256,
                          max_blocks=64)
        batch, rejected = eng.reject_by_radius(batch, res, radius=5.0)
        truth = res.center3d[res.count > 0]
        reg = eng.register_to_truth(res, truth)
        matches = eng.match(res, truth, reg)
        eng.export_scene(os.path.join(outdir, "scene"), batch, res)
        eng.export_centroids(os.path.join(outdir, "centroids.txt"), res)
        eng.export_cluster_points(os.path.join(outdir, "points.txt"),
                                  batch, res)
    # each Engine step's host time, from the recorder's root spans
    for s in rec.spans:
        if s.parent is None and s.name != "sync":
            print(f"{s.name}: {s.duration_ns * 1e-6:.1f} ms "
                  f"({s.counters.get('host_syncs', 0)} host reads)",
                  file=sys.stderr, flush=True)

    out = {"scan_points": int(batch.count),
           "n_clusters": int(res.n_clusters),
           "icp_iterations": int(reg.iterations),
           "converged": bool(reg.converged),
           "n_matched": int(matches["n_matched"]),
           "rmse": float(matches["rmse"])}
    print(f"scan points: {out['scan_points']}")
    print(f"clusters: {out['n_clusters']} (true markers: "
          f"{len(centers_truth)})")
    print(f"icp: {out['icp_iterations']} iters, converged="
          f"{out['converged']}")
    print(f"matched: {out['n_matched']}, rmse={out['rmse']:.3g}")
    print(f"outputs in {outdir}: scene_points.vtk scene_circles.vtk "
          f"centroids.txt points.txt")
    return out


if __name__ == "__main__":
    main()
