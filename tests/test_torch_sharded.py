"""PyTorch port vs the JAX package: the multi-device paths
(vtkcloudpoint_tpu_torch.parallel, the sharded pose graph and BA,
slam_pipeline_ba(mesh=...), halo_buffers(axis=...),
Engine.cluster_sharded) across 2 and 4 real processes on gloo, each held
to JAX's shard_map on make_mesh(2) / make_mesh(4) of the conftest's
virtual CPU devices on the same numpy inputs.

One counterpart for each test of tests/test_sharded.py, the
dryrun_multichip set of modes (__graft_entry__.py) at 4 ranks, and the
two-process cases of tests/test_two_process.py (ring; hier + distributed
noise + split programs; the kill-resume checkpoint).

The rank workers live in this file: ``python tests/test_torch_sharded.py
<rank> <world> <port> <workdir> [phase]`` runs every case of
``workdir/spec.json`` on ``workdir/inputs.npz`` and writes its outputs
(labels gathered to the global layout) to ``workdir/out_<rank>.npz``. A
worker imports torch and the port only, never JAX; its process group has a
60 s timeout and each spawn a deadline, so a hang fails one test.

Tolerances, stated per kind:
- labels, n_total and every overflow counter: bit-equal;
- sharded_icp and sharded_icp_grid: R and t within 1e-6 in float64
  (the port's NN is by direct differences, JAX's sharded_icp by the
  expansion: fixtures keep neighbours untied), iterations equal;
- the sharded pose graph, BA and slam_pipeline_ba(mesh=...): poses and
  landmarks within 1e-9 in float64 (sums in another order);
- halo_buffers(axis=...): coordinates, labels and validity bit-equal.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 420
ICP_TOL = 1e-6
SOLVE_TOL = 1e-9
WORLDS = (2, 4)
JAX_THREADS = 4


# ---------------------------------------------------------------------------
# the rank worker (torch and the port only)
# ---------------------------------------------------------------------------

def _icp_cfg(d):
    from vtkcloudpoint_tpu_torch.config import ICPConfig

    return ICPConfig(**d)


def _run_case(mesh, kind, a, kw):
    """One case on this rank: a dict of numpy outputs (labels gathered to
    the global layout). On the card the float64 cases take the plain
    nearest neighbour (K3 is float32)."""
    import torch

    backend = "torch" if mesh.device.type == "cuda" and any(
        v.dtype == np.float64 for v in a.values()) else "auto"

    from vtkcloudpoint_tpu_torch.parallel import sharded
    from vtkcloudpoint_tpu_torch.parallel.mesh import (gather_blocks,
                                                       replicated,
                                                       shard_blocks)

    def sh(x):
        return shard_blocks(mesh, x)

    def np_(x):
        return np.asarray(x.cpu().numpy() if torch.is_tensor(x) else x)

    if kind == "dbscan":
        out = sharded.sharded_blocked_dbscan(mesh, sh(a["bc"]), sh(a["bv"]),
                                             backend=backend, **kw)
        res = {k: np_(v) for k, v in out.items() if k != "label"}
        res["label"] = np_(gather_blocks(mesh, out["label"]))
        return res
    if kind == "halo_buffers":
        from vtkcloudpoint_tpu_torch.cluster.halo_fusion import halo_buffers

        bloc = a["bc"].shape[0] // mesh.size
        hx, hlab, hval, ovf = halo_buffers(
            sh(a["bc"]), sh(a["bv"]), sh(a["lab"]), sh(a["core"]),
            block_id_offset=mesh.rank * bloc, axis=mesh, **kw)
        return {"hx": np_(gather_blocks(mesh, hx)),
                "hlab": np_(gather_blocks(mesh, hlab)),
                "hval": np_(gather_blocks(mesh, hval)),
                "ovf": np_(mesh.psum(ovf))}
    if kind == "icp":
        r, t, d, it = sharded.sharded_icp(
            mesh, sh(a["src"]), sh(a["sv"]), replicated(mesh, a["tgt"]),
            replicated(mesh, a["tv"]), _icp_cfg(kw["cfg"]), backend=backend)
        return {"r": np_(r), "t": np_(t), "d": np_(d), "it": np_(it)}
    if kind == "icp_grid":
        kw = dict(kw)
        r, t, d, it, ovf = sharded.sharded_icp_grid(
            mesh, sh(a["src"]), sh(a["sv"]), sh(a["tgt"]), sh(a["tv"]),
            _icp_cfg(kw.pop("cfg")), backend=backend, **kw)
        return {"r": np_(r), "t": np_(t), "d": np_(d), "it": np_(it),
                "ovf": np_(ovf)}
    if kind == "posegraph":
        from vtkcloudpoint_tpu_torch.slam.ba import (
            optimize_pose_graph_sharded, pad_pose_graph)
        from vtkcloudpoint_tpu_torch.slam.posegraph import PoseGraph

        graph = pad_pose_graph(PoseGraph(*(torch.from_numpy(a[k]) for k in (
            "ei", "ej", "rm", "tm", "w"))), mesh.size)
        r, t, c = optimize_pose_graph_sharded(
            mesh, replicated(mesh, a["r0"]), replicated(mesh, a["t0"]),
            PoseGraph(*map(sh, graph)), **kw)
        return {"r": np_(r), "t": np_(t), "cost": np_(c)}
    if kind == "ba":
        from vtkcloudpoint_tpu_torch.slam.ba import (Observations,
                                                     bundle_adjust_sharded,
                                                     pad_observations)

        obs = pad_observations(Observations(*(torch.from_numpy(a[k]) for k
                                              in ("pose", "lm", "z", "w"))),
                               mesh.size)
        r, t, lm, c = bundle_adjust_sharded(
            mesh, *(replicated(mesh, a[k]) for k in ("r0", "t0", "l0")),
            Observations(*map(sh, obs)), **kw)
        return {"r": np_(r), "t": np_(t), "lm": np_(lm), "cost": np_(c)}
    if kind == "slam_ba":
        from vtkcloudpoint_tpu_torch.slam.trajectory import slam_pipeline_ba

        kw = dict(kw)
        ba, pg, odo, stats = slam_pipeline_ba(
            replicated(mesh, a["scans"]), replicated(mesh, a["valid"]),
            _icp_cfg(kw.pop("icp_cfg")), mesh=mesh, backend=backend, **kw)
        return {"r": np_(ba.r), "t": np_(ba.t), "pg_r": np_(pg.r),
                "pg_t": np_(pg.t), "n_lm": np_(stats["n_landmarks"])}
    if kind == "engine":
        from vtkcloudpoint_tpu_torch.config import ClusterConfig, EngineConfig
        from vtkcloudpoint_tpu_torch.engine import Engine

        kw = dict(kw)
        eng = Engine(EngineConfig(cluster=ClusterConfig(**kw.pop(
            "cluster"))), device=mesh.device)
        batch = eng.import_arrays(a["motor"], a["rng"])
        out = eng.cluster_sharded(batch, mesh=mesh, **kw)
        res = {k: np_(v) for k, v in out.items()
               if k not in ("label", "point_index")}
        res["label"] = np_(gather_blocks(mesh, out["label"]))
        res["point_index"] = np_(gather_blocks(mesh, out["point_index"]))
        return res
    raise ValueError(kind)


def _worker_main(argv):
    rank, world, port, workdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    phase = argv[4] if len(argv) > 4 else None
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from vtkcloudpoint_tpu_torch.parallel.mesh import make_mesh

    # gloo on the CPU; tools/sharded_cards.py runs the same cases on NCCL,
    # one card a rank
    on_card = os.environ.get("VTKCP_SHARDED_DEVICE", "cpu") == "cuda"
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh(world, device=f"cuda:{rank}" if on_card else "cpu")
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    data = np.load(os.path.join(workdir, "inputs.npz"))
    if phase is not None:
        _checkpoint_phase(phase, rank, workdir, world)
    out = {}
    for case in spec:
        a = {k.split("/", 1)[1]: data[k] for k in data.files
             if k.startswith(case["inputs"] + "/")}
        res = _run_case(mesh, case["kind"], a, case["kw"])
        out.update({f"{case['id']}/{k}": v for k, v in res.items()})
    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _checkpoint_phase(phase, rank, workdir, world):
    """kill: save the split-boundary checkpoint, wait for every peer's, die
    (exit 77: the crash the checkpoint exists to survive; no collective runs
    between the DBSCAN and the save). resume: a checkpoint must be there."""
    import time

    from vtkcloudpoint_tpu_torch.utils import checkpoint as ck

    root = os.path.join(workdir, "ckpt")
    if phase == "kill":
        orig = ck.CheckpointManager.save

        def save_and_die(self, step, tree):
            orig(self, step, tree)
            for p in range(world):
                idx = os.path.join(root, f"p{p}", "index.json")
                for _ in range(600):
                    if os.path.exists(idx):
                        break
                    time.sleep(0.1)
            os._exit(77)

        ck.CheckpointManager.save = save_and_die
    else:
        assert ck.CheckpointManager(os.path.join(root, f"p{rank}"),
                                    keep=1).latest_step() is not None, \
            "resume phase found no checkpoint"


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the parent: inputs, spawns, the JAX side
# ---------------------------------------------------------------------------

def _outputs(workdir, world):
    """Per case id, the outputs of rank 0 -- after checking that every rank
    returned the same (replicated) values."""
    outs = [dict(np.load(os.path.join(workdir, f"out_{r}.npz")))
            for r in range(world)]
    for r in range(1, world):
        assert outs[r].keys() == outs[0].keys()
        for k in outs[0]:
            np.testing.assert_array_equal(outs[r][k], outs[0][k],
                                          err_msg=f"rank {r} {k}")
    res = {}
    for k, v in outs[0].items():
        cid, field = k.split("/", 1)
        res.setdefault(cid, {})[field] = v
    return res


def _blocks(coords, cap, n_blocks):
    """JAX's Morton blocks of a cloud, as numpy (bc, bv)."""
    import jax.numpy as jnp

    from vtkcloudpoint_tpu.cluster.blocks import (assign_blocks_balanced,
                                                  gather_blocks)

    valid = jnp.ones(len(coords), bool)
    part = assign_blocks_balanced(jnp.asarray(coords), valid, cap)
    bc, bv, _, ov = gather_blocks(jnp.asarray(coords), part["block"], valid,
                                  n_blocks, cap)
    assert int(np.asarray(ov).sum()) == 0
    return np.asarray(bc), np.asarray(bv)


def _stripe_scene(seed, n_stripe=120, spread=0.005, n_blob=40, dim=2):
    rng = np.random.default_rng(seed)
    stripe = np.zeros((n_stripe, dim))
    stripe[:, 0] = np.linspace(0, 2.0, n_stripe)
    stripe = np.repeat(stripe, 3, axis=0) + spread * rng.standard_normal(
        (3 * n_stripe, dim))
    centre = np.array([5.0, 5.0, 1.0][:dim])
    blob = centre + 0.01 * rng.standard_normal((n_blob, dim))
    pts = np.concatenate([stripe, blob]).astype(np.float32)
    rng.shuffle(pts)
    return pts


def _blob_scene(seed, noise, pts_per=40, n_clusters=8, spread=0.012):
    from tests.conftest import make_blobs

    return make_blobs(np.random.default_rng(seed), n_clusters=n_clusters,
                      pts_per=pts_per, noise=noise,
                      spread=spread).astype(np.float32)


HALO_KW = dict(eps=0.08, min_pts=6, quirks=False,
               noise_capacity_per_device=128, halo_merge=True, halo_cap=64,
               max_ids=128)
NOISE_KW = dict(eps=0.06, min_pts=9, quirks=True,
                noise_capacity_per_device=256)


def _dryrun_inputs():
    """__graft_entry__.dryrun_multichip's cloud at 4 devices."""
    from __graft_entry__ import _synthetic_scan

    n_dev, cap = 4, 64
    n = n_dev * 2 * cap
    motor, xyz, truth = _synthetic_scan(n, 32, seed=1)
    bc, bv = _blocks(motor, cap, n_dev * 2)
    tgt3 = np.concatenate([motor, np.zeros((n, 1), np.float32)], axis=1)
    qn = n_dev * 32
    return motor, xyz, truth, bc, bv, tgt3, qn


def _build_cases():
    """(inputs {name: {array: ndarray}}, cases [{id, kind, inputs, kw,
    worlds}])."""
    import tests.test_ba as tba_j
    from tests.two_process_common import make_case

    inputs, cases = {}, []

    def case(cid, kind, inp, kw, worlds=WORLDS, jax=True):
        """``jax=False``: a mode held to JAX through a sibling mode that is
        (the tests assert the two port modes equal)."""
        cases.append({"id": cid, "kind": kind, "inputs": inp, "kw": kw,
                      "worlds": list(worlds), "jax": jax})

    bc, bv = _blocks(_blob_scene(0, 80), 128, 8)
    inputs["blobs0"] = {"bc": bc, "bv": bv}
    case("single", "dbscan", "blobs0", NOISE_KW)

    for seed in (3, 4):
        bc, bv = _blocks(_stripe_scene(seed), 64, 8)
        inputs[f"stripe{seed}"] = {"bc": bc, "bv": bv}
    case("halo_single", "dbscan", "stripe3", HALO_KW)
    case("ring", "dbscan", "stripe4", dict(HALO_KW, halo_mode="ring"),
         jax=False)
    case("gather", "dbscan", "stripe4", dict(HALO_KW, halo_mode="gather"))
    case("hier", "dbscan", "stripe4", dict(HALO_KW, halo_mode="hier",
                                           dev_halo_cap=512,
                                           halo_cell_cap=64), jax=False)

    bc, bv = _blocks(_blob_scene(5, 80), 128, 8)
    inputs["blobs5"] = {"bc": bc, "bv": bv}
    case("noise_grid", "dbscan", "blobs5", dict(NOISE_KW,
                                                noise_recluster="grid"))
    case("noise_dense", "dbscan", "blobs5", dict(NOISE_KW,
                                                 noise_recluster="dense"),
         jax=False)

    bc, bv = _blocks(_blob_scene(15, 200), 128, 8)
    inputs["blobs15"] = {"bc": bc, "bv": bv}
    dist_kw = dict(NOISE_KW, noise_cell_cap=256)
    case("dist_grid", "dbscan", "blobs15", dict(dist_kw,
                                                noise_recluster="grid"),
         jax=False)
    case("dist", "dbscan", "blobs15", dict(
        dist_kw, noise_recluster="distributed", noise_skin_cap=512,
        noise_root_cap=512))

    bc, bv = _blocks(_blob_scene(16, 80), 128, 8)
    inputs["blobs16"] = {"bc": bc, "bv": bv}
    split_kw = dict(NOISE_KW, halo_merge=True, max_ids=512,
                    halo_mode="hier", dev_halo_cap=256, halo_cell_cap=128,
                    noise_recluster="distributed", noise_skin_cap=512,
                    noise_root_cap=512, noise_cell_cap=256)
    case("fused", "dbscan", "blobs16", split_kw)
    case("split", "dbscan", "blobs16", dict(split_kw, split_programs=True),
         jax=False)

    bc, bv = _blocks(_blob_scene(6, 200, pts_per=30, n_clusters=2,
                                 spread=0.01), 64, 8)
    inputs["blobs6"] = {"bc": bc, "bv": bv}
    case("noise_ovf", "dbscan", "blobs6", dict(
        eps=0.06, min_pts=9, quirks=False, noise_capacity_per_device=8))

    bc, bv = _blocks(_stripe_scene(7, dim=3), 64, 8)
    inputs["stripe7"] = {"bc": bc, "bv": bv}
    kw3 = dict(HALO_KW, metric="l2_xyz")
    case("hier3d", "dbscan", "stripe7", dict(kw3, halo_mode="hier",
                                             dev_halo_cap=512,
                                             halo_cell_cap=96), jax=False)
    case("gather3d", "dbscan", "stripe7", dict(kw3, halo_mode="gather"))

    bc, bv = _blocks(_blob_scene(17, 200), 128, 8)
    inputs["blobs17"] = {"bc": bc, "bv": bv}
    le_kw = dict(NOISE_KW, noise_cell_cap=256, noise_recluster="distributed",
                 noise_skin_cap=512, noise_root_cap=512)
    case("local_grid", "dbscan", "blobs17", dict(le_kw,
                                                 noise_local_engine="grid"))
    case("local_dense", "dbscan", "blobs17", dict(
        le_kw, noise_local_engine="dense"), jax=False)

    bc, bv = _blocks(_blob_scene(19, 40), 128, 8)
    inputs["blobs19"] = {"bc": bc, "bv": bv}
    cm_kw = dict(eps=0.06, min_pts=9, quirks=False,
                 noise_capacity_per_device=256, max_ids=256)
    case("cm_base", "dbscan", "blobs19", cm_kw)
    case("cm", "dbscan", "blobs19", dict(cm_kw, centroid_merge=True,
                                         merge_eps=0.4))

    bc, bv = _blocks(_stripe_scene(11, n_stripe=150, spread=0.004,
                                   n_blob=62), 64, 8)
    inputs["stripe11"] = {"bc": bc, "bv": bv}
    own_kw = dict(HALO_KW, halo_mode="hier", dev_halo_cap=512,
                  halo_cell_cap=64)
    case("owner", "dbscan", "stripe11", dict(own_kw, skin_exchange="owner"),
         jax=False)
    case("skin_gather", "dbscan", "stripe11", dict(own_kw,
                                                   skin_exchange="gather"))
    bc, bv = _blocks(_stripe_scene(12, n_stripe=150, spread=0.004,
                                   n_blob=62), 64, 8)
    inputs["stripe12"] = {"bc": bc, "bv": bv}
    case("dest_cap", "dbscan", "stripe12", dict(own_kw, skin_exchange="owner",
                                                skin_dest_cap=1))

    # ICP, float64 (tests/test_sharded.py's problems)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, size=(512, 3)) * np.array([5, 5, 1])
    c, s_ = np.cos(0.12), np.sin(0.12)
    r_true = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]])
    inputs["icp"] = {"src": pts, "sv": np.ones(512, bool),
                     "tgt": pts @ r_true.T + np.array([0.4, -0.1, 0.2]),
                     "tv": np.ones(512, bool)}
    case("icp", "icp", "icp", {"cfg": {"tol": 1e-12}})

    rng = np.random.default_rng(11)
    m, n = 8 * 2048, 8 * 256
    tgt = rng.uniform(-2, 2, size=(m, 3))
    src = tgt[rng.choice(m, n, replace=False)]
    c, s_ = np.cos(0.05), np.sin(0.05)
    r_true = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]])
    src = (src - np.array([0.08, -0.05, 0.02])) @ r_true
    inputs["icp_grid"] = {"src": src, "sv": np.ones(n, bool), "tgt": tgt,
                          "tv": np.ones(m, bool)}
    gcfg = {"max_iterations": 30, "tol": 1e-12}
    case("icp_grid", "icp_grid", "icp_grid", dict(
        cfg=gcfg, cell_size=0.25, cell_cap=64, fallback_cap=512, chunk=512,
        nn="grid"))
    case("icp_brute", "icp_grid", "icp_grid", dict(
        cfg=gcfg, cell_size=0.25, chunk=512, nn="brute"), jax=False)

    # halo_buffers(axis=...) on the stripe scene's DBSCAN labels
    bc4, bv4 = inputs["stripe4"]["bc"], inputs["stripe4"]["bv"]
    from vtkcloudpoint_tpu.cluster.dbscan import dbscan_blocks
    db = dbscan_blocks(bc4, bv4, 0.08, 6, "l1_motor")
    lab = np.asarray(db["label"]).astype(np.int32)
    lab = np.where(lab > 0, lab + 10 * np.arange(8)[:, None], 0).astype(
        np.int32)
    inputs["halo_buf"] = {"bc": bc4, "bv": bv4, "lab": lab,
                          "core": np.asarray(db["core"])}
    case("halo_buffers", "halo_buffers", "halo_buf", dict(
        eps=0.08, halo_cap=32, cell_table_bits=16))

    # the sharded pose graph and BA (tests/test_ba.py's problems)
    _, (r0, t0), graph = tba_j._make_problem()
    inputs["pg"] = {"r0": np.asarray(r0), "t0": np.asarray(t0),
                    **{k: np.asarray(v) for k, v in zip(
                        ("ei", "ej", "rm", "tm", "w"), graph)}}
    case("posegraph", "posegraph", "pg", {"iterations": 8})
    _, (r0, t0, l0), obs = tba_j._make_ba_problem()
    inputs["ba"] = {"r0": np.asarray(r0), "t0": np.asarray(t0),
                    "l0": np.asarray(l0),
                    **{k: np.asarray(v) for k, v in zip(
                        ("pose", "lm", "z", "w"), obs)}}
    case("ba", "ba", "ba", {"iterations": 15, "damping": 1e-6})

    # slam_pipeline_ba(mesh=...) on a small landmark survey (float64)
    from tests.test_torch_slam import _ba_scans
    scans = _ba_scans(np.random.default_rng(2), s=8, n=300, n_marks=6)[0]
    inputs["slam"] = {"scans": scans,
                      "valid": np.ones(scans.shape[:2], bool)}
    case("slam_ba", "slam_ba", "slam", dict(
        icp_cfg={"max_iterations": 25, "tol": 1e-10}, loop_radius=3.0,
        gn_iterations=5, landmark_eps=0.3, landmark_min_pts=5,
        max_clusters_per_scan=8, ba_iterations=4))

    # Engine.cluster_sharded (tests/test_engine.py's scene)
    rng = np.random.default_rng(3)
    centers = rng.uniform(0.1, 0.9, (12, 2))
    motor = np.concatenate([cc + 0.004 * rng.standard_normal((70, 2))
                            for cc in centers]).astype(np.float32)
    rng.shuffle(motor)
    inputs["engine"] = {"motor": motor,
                        "rng": np.full(len(motor), 10.0, np.float32)}
    case("engine", "engine", "engine", dict(
        cluster=dict(eps=0.02, min_pts=5, block_capacity=128),
        noise_capacity_per_device=256, halo_cap=128, halo_cell_cap=96,
        max_ids=1024, quirks=False, cell_table_bits=16))

    # dryrun_multichip's modes at 4 ranks
    motor, xyz, truth, bc, bv, tgt3, qn = _dryrun_inputs()
    inputs["dry"] = {"bc": bc, "bv": bv}
    dry = dict(eps=0.02, min_pts=5, quirks=False,
               noise_capacity_per_device=128, max_ids=512)
    case("dry_ring", "dbscan", "dry", dict(
        dry, halo_merge=True, halo_mode="ring", noise_cell_cap=128), [4])
    case("dry_hier", "dbscan", "dry", dict(
        dry, halo_merge=True, halo_mode="hier", dev_halo_cap=256,
        halo_cell_cap=128, skin_exchange="owner", noise_cell_cap=128,
        noise_recluster="distributed", noise_skin_cap=256,
        noise_root_cap=256, split_programs=True), [4])
    case("dry_cm", "dbscan", "dry", dict(dry, centroid_merge=True,
                                         merge_eps=0.05, merge_min_pts=2),
         [4])
    inputs["dry_icp"] = {"src": xyz[:4 * 32].astype(np.float64),
                         "sv": np.ones(4 * 32, bool),
                         "tgt": truth.astype(np.float64),
                         "tv": np.ones(len(truth), bool)}
    case("dry_icp", "icp", "dry_icp", {"cfg": {"max_iterations": 5}}, [4])
    src3 = tgt3[:qn] + np.float32([0.003, -0.002, 0.0])
    inputs["dry_grid"] = {"src": src3.astype(np.float64),
                          "sv": np.ones(qn, bool),
                          "tgt": tgt3.astype(np.float64),
                          "tv": np.ones(len(tgt3), bool)}
    case("dry_icp_grid", "icp_grid", "dry_grid", dict(
        cfg={"max_iterations": 4}, cell_size=0.05, cell_cap=32,
        fallback_cap=256, chunk=32, nn="grid"), [4])

    # tests/test_two_process.py's cases at 2 ranks
    bc, bv = make_case()
    inputs["two"] = {"bc": bc, "bv": bv}
    case("two_ring", "dbscan", "two", dict(_TWO_KW, halo_mode="ring"), [2])
    case("two_hier", "dbscan", "two", dict(_TWO_KW, **_TWO_HIER), [2])
    return inputs, cases


_TWO_KW = dict(eps=0.08, min_pts=6, quirks=False,
               noise_capacity_per_device=128, halo_merge=True, halo_cap=64,
               max_ids=256)
_TWO_HIER = dict(halo_mode="hier", dev_halo_cap=256, halo_cell_cap=128,
                 noise_recluster="distributed", noise_skin_cap=128,
                 noise_root_cap=128, noise_cell_cap=128, split_programs=True)


def _write(workdir, inputs, cases):
    os.makedirs(workdir, exist_ok=True)
    np.savez(os.path.join(workdir, "inputs.npz"),
             **{f"{name}/{k}": v for name, arrs in inputs.items()
                for k, v in arrs.items()})
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(cases, f)


@pytest.fixture(scope="module")
def built():
    return _build_cases()


def _start(world, workdir, phase=None, device="cpu"):
    """Launch ``world`` rank workers on ``workdir``; returns the processes
    (``_join`` waits for them)."""
    from vtkcloudpoint_tpu_torch.parallel.distributed import free_port

    port = str(free_port())
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"
    env["VTKCP_SHARDED_DEVICE"] = device
    # by path: an installed package named "tests" would shadow this one
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), port,
         str(workdir)] + ([phase] if phase else []),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]


def _join(procs, expect_rc=0):
    """Wait for the workers (each within the spawn deadline) and check
    their exit codes."""
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{len(procs)}-rank workers timed out")
        logs.append(out.decode(errors="replace"))
    for r, p in enumerate(procs):
        assert p.returncode == expect_rc, \
            f"rank {r} rc={p.returncode}\n{logs[r][-4000:]}"


@pytest.fixture(scope="module")
def runs(built, tmp_path_factory):
    """Every case through the port, one spawn of ``world`` processes per
    world size (both started at once), and the JAX side of every case held
    to JAX, computed while the workers run. Returns ({world: {case id:
    outputs}}, {(case id, world): JAX outputs})."""
    inputs, cases = built
    started = {}
    for world in WORLDS:
        workdir = tmp_path_factory.mktemp(f"ranks{world}")
        _write(workdir, inputs, [c for c in cases if world in c["worlds"]])
        started[world] = (workdir, _start(world, workdir))
    try:
        # XLA compiles outside the GIL: a few threads overlap the compiles
        from concurrent.futures import ThreadPoolExecutor

        todo = [(c, w) for c in cases if c["jax"] for w in c["worlds"]]
        with ThreadPoolExecutor(JAX_THREADS) as pool:
            done = list(pool.map(lambda cw: _jax_case(cw[0], inputs, cw[1]),
                                 todo))
        jax_out = {(c["id"], w): out for (c, w), out in zip(todo, done)}
    finally:
        for world, (workdir, procs) in started.items():
            _join(procs)
    return ({w: _outputs(wd, w) for w, (wd, _) in started.items()},
            jax_out)


# ---- the JAX side ----

def _jax_case(case, inputs, world):
    """The same case through the JAX package on make_mesh(world)."""
    import jax
    import jax.numpy as jnp

    from vtkcloudpoint_tpu.config import ICPConfig
    from vtkcloudpoint_tpu.parallel import sharded as js
    from vtkcloudpoint_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(world)
    a = inputs[case["inputs"]]
    kw = dict(case["kw"])
    kind = case["kind"]
    if kind == "dbscan":
        out = js.sharded_blocked_dbscan(mesh, jnp.asarray(a["bc"]),
                                        jnp.asarray(a["bv"]), **kw)
        return {k: np.asarray(v) for k, v in out.items()}
    if kind == "icp":
        r, t, d, it = js.sharded_icp(
            mesh, *map(jnp.asarray, (a["src"], a["sv"], a["tgt"], a["tv"])),
            ICPConfig(**kw["cfg"]))
        return {"r": np.asarray(r), "t": np.asarray(t), "it": np.asarray(it)}
    if kind == "icp_grid":
        cfg = ICPConfig(**kw.pop("cfg"))
        r, t, d, it, ovf = js.sharded_icp_grid(
            mesh, *map(jnp.asarray, (a["src"], a["sv"], a["tgt"], a["tv"])),
            cfg, **kw)
        return {"r": np.asarray(r), "t": np.asarray(t), "it": np.asarray(it),
                "ovf": np.asarray(ovf)}
    if kind == "halo_buffers":
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from vtkcloudpoint_tpu.cluster.halo_fusion import halo_buffers

        def fn(bc, bv, lab, core):
            dev = jax.lax.axis_index("blocks")
            hx, hlab, hval, ovf = halo_buffers(
                bc, bv, lab, core, block_id_offset=dev * bc.shape[0],
                axis="blocks", **kw)
            return hx, hlab, hval, jax.lax.psum(ovf, "blocks")[None]

        spec = P("blocks")
        hx, hlab, hval, ovf = jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(spec,) * 4,
            out_specs=(spec, spec, spec, P()), check_vma=False))(
            *map(jnp.asarray, (a["bc"], a["bv"], a["lab"], a["core"])))
        return {"hx": np.asarray(hx), "hlab": np.asarray(hlab),
                "hval": np.asarray(hval), "ovf": np.asarray(ovf)[0]}
    if kind == "posegraph":
        from vtkcloudpoint_tpu.slam.ba import optimize_pose_graph_sharded
        from vtkcloudpoint_tpu.slam.posegraph import PoseGraph

        graph = PoseGraph(*(jnp.asarray(a[k]) for k in ("ei", "ej", "rm",
                                                        "tm", "w")))
        r, t, c = optimize_pose_graph_sharded(
            mesh, jnp.asarray(a["r0"]), jnp.asarray(a["t0"]), graph, **kw)
        return {"r": np.asarray(r), "t": np.asarray(t), "cost": np.asarray(c)}
    if kind == "ba":
        from vtkcloudpoint_tpu.slam.ba import (Observations,
                                               bundle_adjust_sharded)

        obs = Observations(*(jnp.asarray(a[k]) for k in ("pose", "lm", "z",
                                                         "w")))
        r, t, lm, c = bundle_adjust_sharded(
            mesh, *(jnp.asarray(a[k]) for k in ("r0", "t0", "l0")), obs, **kw)
        return {"r": np.asarray(r), "t": np.asarray(t), "lm": np.asarray(lm),
                "cost": np.asarray(c)}
    if kind == "slam_ba":
        from vtkcloudpoint_tpu.slam.trajectory import slam_pipeline_ba

        ba, pg, _, stats = slam_pipeline_ba(
            jnp.asarray(a["scans"]), jnp.asarray(a["valid"]),
            ICPConfig(**kw.pop("icp_cfg")), mesh=mesh, **kw)
        return {"r": np.asarray(ba.r), "t": np.asarray(ba.t),
                "pg_r": np.asarray(pg.r), "pg_t": np.asarray(pg.t),
                "n_lm": np.asarray(stats["n_landmarks"])}
    if kind == "engine":
        from vtkcloudpoint_tpu.config import ClusterConfig, EngineConfig
        from vtkcloudpoint_tpu.engine import Engine

        eng = Engine(EngineConfig(cluster=ClusterConfig(**kw.pop(
            "cluster"))))
        batch = eng.import_arrays(a["motor"], a["rng"])
        out = eng.cluster_sharded(batch, mesh=mesh, **kw)
        return {k: np.asarray(v) for k, v in out.items()}
    raise ValueError(kind)


def _held(runs, cid, world):
    """(port outputs, JAX outputs) of one case at one world size."""
    return runs[0][world][cid], runs[1][(cid, world)]


def _equal(port, jax_out, keys=("label", "n_total", "noise_overflow",
                                "halo_overflow")):
    for k in keys:
        np.testing.assert_array_equal(port[k], jax_out[k], err_msg=k)


def _close(port, jax_out, keys, tol):
    for k in keys:
        np.testing.assert_allclose(port[k], jax_out[k], rtol=0, atol=tol,
                                   err_msg=k)


# ---- one counterpart per test of tests/test_sharded.py ----

def _same_labels(runs, world, a, b):
    """Two port modes of one scene give the same labels and n_total."""
    pa, pb = runs[0][world][a], runs[0][world][b]
    np.testing.assert_array_equal(pa["label"], pb["label"])
    assert int(pa["n_total"]) == int(pb["n_total"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_dbscan_matches_single(runs, world):
    port, jx = _held(runs, "single", world)
    _equal(port, jx)
    assert int(port["noise_overflow"]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_icp_matches_single(runs, world):
    port, jx = _held(runs, "icp", world)
    _close(port, jx, ("r", "t"), ICP_TOL)
    assert int(port["it"]) == int(jx["it"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_halo_merge_matches_single(runs, world):
    port, jx = _held(runs, "halo_single", world)
    _equal(port, jx)
    assert int(port["n_total"]) == 2


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_halo_ring_matches_gather(runs, world):
    """The ring union equals the gathered union, which equals JAX's."""
    port, jx = _held(runs, "gather", world)
    _equal(port, jx)
    _same_labels(runs, world, "ring", "gather")
    ring = runs[0][world]["ring"]
    assert int(ring["n_total"]) == 2 and int(ring["halo_overflow"]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_halo_hier_matches_gather(runs, world):
    port, jx = _held(runs, "gather", world)
    _equal(port, jx)
    _same_labels(runs, world, "hier", "gather")
    hier = runs[0][world]["hier"]
    assert int(hier["n_total"]) == 2 and int(hier["halo_overflow"]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_noise_recluster_grid_matches_dense(runs, world):
    port, jx = _held(runs, "noise_grid", world)
    _equal(port, jx)
    _same_labels(runs, world, "noise_grid", "noise_dense")
    assert int(port["noise_overflow"]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_noise_recluster_distributed_matches_grid(runs, world):
    port, jx = _held(runs, "dist", world)
    _equal(port, jx)
    _same_labels(runs, world, "dist", "dist_grid")
    assert int(port["noise_overflow"]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_split_programs_matches_fused(runs, world):
    port, jx = _held(runs, "fused", world)
    _equal(port, jx)
    _same_labels(runs, world, "fused", "split")
    assert int(runs[0][world]["split"]["halo_overflow"]) == int(
        port["halo_overflow"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_noise_overflow_counter(runs, world):
    port, jx = _held(runs, "noise_ovf", world)
    _equal(port, jx)
    assert int(port["noise_overflow"]) > 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_halo_hier_matches_gather_3d(runs, world):
    port, jx = _held(runs, "gather3d", world)
    _equal(port, jx)
    _same_labels(runs, world, "hier3d", "gather3d")
    hier = runs[0][world]["hier3d"]
    assert int(hier["n_total"]) == 2 and int(hier["halo_overflow"]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_icp_grid_matches_single_device(runs, world):
    """float64; the grid locator equals JAX's within 1e-6, and the brute
    locator (K3 on the card) gives the grid's transform within 1e-6."""
    port, jx = _held(runs, "icp_grid", world)
    _close(port, jx, ("r", "t"), ICP_TOL)
    assert int(port["it"]) == int(jx["it"])
    assert int(port["ovf"]) == int(jx["ovf"]) == 0
    brute = runs[0][world]["icp_brute"]
    _close(brute, port, ("r", "t"), ICP_TOL)
    assert int(brute["it"]) == int(port["it"]) and int(brute["ovf"]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_noise_local_engine_dense_matches_grid(runs, world):
    port, jx = _held(runs, "local_grid", world)
    _equal(port, jx)
    _same_labels(runs, world, "local_grid", "local_dense")
    assert int(runs[0][world]["local_dense"]["noise_overflow"]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_centroid_merge_matches_single(built, runs, world):
    """The merge sums exact int64 fixed-point centroid moments across ranks,
    so it equals the port's single-device merge on the gathered labels bit
    for bit (and JAX's psum'd merge on this fixture)."""
    import torch

    from vtkcloudpoint_tpu_torch.cluster.fusion import \
        merge_centroid_clusters
    from vtkcloudpoint_tpu_torch.ops.segment import cluster_means

    for cid in ("cm_base", "cm"):
        port, jx = _held(runs, cid, world)
        _equal(port, jx)
    base = runs[0][world]["cm_base"]
    bc = built[0]["blobs19"]["bc"]
    bv = built[0]["blobs19"]["bv"]
    lab = torch.from_numpy(base["label"].reshape(-1))
    vflat = torch.from_numpy(bv.reshape(-1).copy()) & (lab > 0)
    cen, cnt = cluster_means(torch.from_numpy(bc.reshape(-1, 2).copy()), lab,
                             vflat, 256)
    mg = merge_centroid_clusters(cen[:, :2], cnt > 0, 0.4)
    want = mg["remap"].numpy()[np.clip(base["label"], 0, 255)]
    np.testing.assert_array_equal(runs[0][world]["cm"]["label"], want)
    assert int(runs[0][world]["cm"]["n_total"]) == int(mg["n_after"]) \
        < int(base["n_total"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_skin_exchange_owner_matches_gather(runs, world):
    port, jx = _held(runs, "skin_gather", world)
    _equal(port, jx)
    _same_labels(runs, world, "owner", "skin_gather")
    owner = runs[0][world]["owner"]
    assert int(owner["n_total"]) == 2 and int(owner["halo_overflow"]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_skin_owner_dest_cap_overflow_surfaces(runs, world):
    port, jx = _held(runs, "dest_cap", world)
    _equal(port, jx)
    assert int(port["halo_overflow"]) > 0


# ---- the multi-device branches outside parallel/ ----

@pytest.mark.parametrize("world", WORLDS)
def test_halo_buffers_axis_matches_jax(runs, world):
    port, jx = _held(runs, "halo_buffers", world)
    _equal(port, jx, ("hx", "hlab", "hval", "ovf"))
    assert port["hval"].sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_pose_graph_sharded_matches_jax(runs, world):
    port, jx = _held(runs, "posegraph", world)
    _close(port, jx, ("r", "t"), SOLVE_TOL)
    np.testing.assert_allclose(port["cost"], jx["cost"], rtol=1e-9,
                               atol=1e-18)


@pytest.mark.parametrize("world", WORLDS)
def test_bundle_adjust_sharded_matches_jax(runs, world):
    port, jx = _held(runs, "ba", world)
    _close(port, jx, ("r", "t", "lm"), SOLVE_TOL)
    np.testing.assert_allclose(port["cost"], jx["cost"], rtol=1e-9,
                               atol=1e-18)


@pytest.mark.parametrize("world", WORLDS)
def test_slam_pipeline_ba_mesh_matches_jax(runs, world):
    port, jx = _held(runs, "slam_ba", world)
    _close(port, jx, ("r", "t", "pg_r", "pg_t"), SOLVE_TOL)
    assert int(port["n_lm"]) == int(jx["n_lm"]) > 0


@pytest.mark.parametrize("world", WORLDS)
def test_engine_cluster_sharded_matches_jax(runs, world):
    port, jx = _held(runs, "engine", world)
    _equal(port, jx, ("label", "point_index", "n_total", "noise_overflow",
                      "halo_overflow"))
    assert int(port["n_total"]) >= 12 and int(port["noise_overflow"]) == 0


# ---- __graft_entry__.dryrun_multichip's modes, 4 ranks ----

def test_dryrun_multichip_modes_match_jax(runs):
    for cid in ("dry_ring", "dry_hier", "dry_cm"):
        port, jx = _held(runs, cid, 4)
        _equal(port, jx)
    np.testing.assert_array_equal(runs[0][4]["dry_ring"]["label"],
                                  runs[0][4]["dry_hier"]["label"])
    for cid in ("dry_icp", "dry_icp_grid"):
        port, jx = _held(runs, cid, 4)
        _close(port, jx, ("r", "t"), ICP_TOL)
        assert int(port["it"]) == int(jx["it"])
    assert int(runs[0][4]["dry_icp_grid"]["ovf"]) == 0


# ---- tests/test_two_process.py's cases, 2 ranks ----

@pytest.mark.parametrize("cid", ["two_ring", "two_hier"])
def test_two_process_matches_single(runs, cid):
    port, jx = _held(runs, cid, 2)
    _equal(port, jx)


def test_two_process_kill_resume_checkpoint(built, runs, tmp_path):
    """Phase 1: both ranks die (exit 77) the instant the split-boundary
    checkpoint is saved. Phase 2 relaunches with the same checkpoint
    directory, must find it, and gives the JAX result (and the
    uncheckpointed run's)."""
    inputs, _ = built
    case = {"id": "ckpt", "kind": "dbscan", "inputs": "two",
            "kw": dict(_TWO_KW, **_TWO_HIER,
                       checkpoint_dir=str(tmp_path / "ckpt")), "worlds": [2]}
    _write(tmp_path, {"two": inputs["two"]}, [case])
    _join(_start(2, tmp_path, "kill"), expect_rc=77)
    for r in range(2):
        assert (tmp_path / "ckpt" / f"p{r}" / "ckpt_0.npz").exists()
    _join(_start(2, tmp_path, "resume"))
    port = _outputs(tmp_path, 2)["ckpt"]
    _equal(port, runs[1][("two_hier", 2)])


# ---- the mesh's own rules, one process ----

def test_make_mesh_refuses_a_size_the_world_lacks(monkeypatch):
    """No process group: make_mesh raises. A one-rank gloo group: make_mesh(2)
    raises (never a 1-rank "2-device" mesh), make_mesh(1) holds the rank;
    a single process needs no initialize, and owns every block."""
    from vtkcloudpoint_tpu_torch.parallel import distributed
    from vtkcloudpoint_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, device="cpu")
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize("127.0.0.1:1", num_processes=1) is False
    with distributed.one_rank_group("cpu") as mesh:
        with pytest.raises(RuntimeError, match="1 rank"):
            make_mesh(2, device="cpu")
        assert mesh.size == 1 and mesh.shape == {"blocks": 1}
        assert distributed.host_local_slice(10) == (0, 10)
        assert distributed.global_mesh(device="cpu").size == 1
