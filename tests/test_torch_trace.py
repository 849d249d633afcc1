"""The port's spans and counters (utils/profiling.py) on the CPU: what each
layer records, that recording changes no result, and that the spans lie
on the profiler's clock.

Card-only checks (every host read goes through ``profiling.sync``; a
kernel's launch lies inside its span) are in tests/test_torch_cuda.py.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from vtkcloudpoint_tpu_torch.cluster.pipeline import cluster_scan
from vtkcloudpoint_tpu_torch.config import (ClusterConfig, EngineConfig,
                                            ICPConfig)
from vtkcloudpoint_tpu_torch.engine import Engine
from vtkcloudpoint_tpu_torch.ops import se3
from vtkcloudpoint_tpu_torch.register.icp import icp
from vtkcloudpoint_tpu_torch.slam.trajectory import slam_pipeline_ba
from vtkcloudpoint_tpu_torch.utils import profiling as prof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("partition", "dbscan", "fusion", "stats", "bucket", "shapes")
# the reads of the card in every ICP iteration, in order: the Horn
# solve's weight sum (a copy from the host), eigh's error check, the
# eigenvector that argmax picks, and the convergence flag
ICP_READS_PER_ITERATION = 4
# and once a call: the starting error, a copy from the host
ICP_READS_PER_CALL = 1
CFG = EngineConfig(cluster=ClusterConfig(eps=0.08, min_pts=8,
                                         pts_in_cell=64, block_capacity=128))
CAPS = dict(max_blocks=16, max_clusters=64, cluster_capacity=128,
            noise_capacity=256, max_hull=16)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: under parallel test workers, torch's thread pool
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan(seed=3, blobs=8, per=60, noise=60):
    """(motor [N, 2] degrees, range [N]) of a few tight blobs and noise."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(10.0, 20.0, (blobs, 2))
    motor = np.concatenate(
        [c + 0.01 * rng.standard_normal((per, 2)) for c in centres]
        + [rng.uniform(10.0, 20.0, (noise, 2))]).astype(np.float32)
    dist = rng.uniform(39.0, 41.0, len(motor)).astype(np.float32)
    return motor, dist


def _batch():
    motor, dist = _scan()
    return Engine(CFG, device="cpu").import_arrays(motor, dist)


def _cluster(batch):
    return cluster_scan(batch.xyz, batch.motor, batch.valid, CFG,
                        mode="balanced", quirks=False, **CAPS)


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_recording_off_leaves_no_records_and_changes_no_result():
    batch = _batch()
    before = len(prof.records())
    assert not prof.on()
    off = _cluster(batch)
    assert len(prof.records()) == before
    with prof.recording() as rec:
        on = _cluster(batch)
    assert rec.spans and not prof.on()
    for name, a, b in zip(off._fields, off, on):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_cluster_scan_records_its_stages_in_order():
    batch = _batch()
    with prof.recording() as rec:
        res = _cluster(batch)
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["cluster_scan"]
    root = roots[0]
    kids = [s for s in _children(rec.spans, root) if s.name != "sync"]
    assert [s.name for s in kids] == list(STAGES)
    for s in rec.spans:
        assert s.root == root.id
        if s.parent is not None:
            parent = next(p for p in rec.spans if p.id == s.parent)
            assert _inside(s, parent), (s, parent)
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    fusion = kids[STAGES.index("fusion")]
    noise = [s for s in rec.spans if s.name == "noise"]
    assert len(noise) == 1 and noise[0].parent == fusion.id
    # the noise re-cluster reads the copy of its label bound, then one
    # flag a sweep
    sweeps = noise[0].counters["sweeps"]
    assert sweeps >= 1 and noise[0].counters["host_syncs"] == 1 + sweeps
    reads = [s for s in _children(rec.spans, noise[0]) if s.name == "sync"]
    assert len(reads) == 1 + sweeps
    assert int(res.n_clusters) > 3


def _icp_case(n=60, seed=1):
    rng = np.random.default_rng(seed)
    tgt = torch.from_numpy(rng.uniform(-5, 5, (n, 3)).astype(np.float32))
    r = se3.rotz(torch.tensor(0.05, dtype=torch.float32))
    src = (tgt - torch.tensor([0.2, -0.1, 0.05])) @ r
    ones = torch.ones(n, dtype=torch.bool)
    return src, ones, tgt, ones


@pytest.mark.parametrize("max_iterations", [1, 5, 40])
def test_icp_counts_its_iterations_and_its_reads(max_iterations):
    cfg = ICPConfig(max_iterations=max_iterations)
    with prof.recording() as rec:
        res = icp(*_icp_case(), cfg)
    (span,) = [s for s in rec.spans if s.name == "icp"]
    it = int(res.iterations)
    assert span.counters["iterations"] == it >= 1
    want = ICP_READS_PER_CALL + ICP_READS_PER_ITERATION * it
    assert span.counters["host_syncs"] == want
    reads = [s for s in rec.spans if s.name == "sync"]
    assert len(reads) == want and all(s.parent == span.id for s in reads)
    if max_iterations == 40:
        assert bool(res.converged) and it < 40


def test_engine_session_gives_one_span_a_method():
    motor, dist = _scan()
    eng = Engine(CFG, device="cpu")
    called = ["import_arrays", "filter_by_distance", "cluster",
              "reject_by_radius", "register_to_truth", "match",
              "export_centroids"]
    with prof.recording() as rec:
        batch = eng.import_arrays(motor, dist)
        batch = eng.filter_by_distance(batch, 10.0, 100.0)
        res = eng.cluster(batch, mode="balanced", **CAPS)
        batch, _ = eng.reject_by_radius(batch, res, radius=5.0)
        truth = res.center3d[res.count > 0]
        reg = eng.register_to_truth(res, truth)
        eng.match(res, truth, reg)
        eng.export_centroids(os.devnull, res)
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == called
    for root in roots:
        assert all(s.root == root.id for s in rec.spans
                   if root.start_ns <= s.start_ns <= root.end_ns)
    # the methods an Engine method calls are spans of their own inside it
    reg_span = roots[called.index("register_to_truth")]
    assert [s.name for s in _children(rec.spans, reg_span)
            if s.name != "sync"] == ["coarse_align", "icp"]
    assert int(reg.iterations) >= 1


def _survey(s=6, n=96, marks=6, seed=2):
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-8, 8, (marks, 3)) * [1, 1, 0.2]
    world = np.concatenate(
        [m + 0.05 * rng.standard_normal((n // marks, 3)) for m in lm])
    scans = []
    for k in range(s):
        th = 0.05 * k
        r = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th),
                      np.cos(th), 0], [0, 0, 1]])
        scans.append((world - [0.3 * k, 0, 0]) @ r)
    scans = torch.from_numpy(np.stack(scans).astype(np.float64))
    return scans, torch.ones(scans.shape[:2], dtype=torch.bool)


def test_slam_records_its_stages_under_one_root_and_calls_the_timer():
    timed = []

    def timer(name):
        timed.append(name)
        return prof.span("timer." + name)

    scans, valid = _survey()
    with prof.recording() as rec:
        slam_pipeline_ba(scans, valid, ICPConfig(max_iterations=10),
                         loop_radius=1.0, gn_iterations=2, landmark_eps=0.3,
                         landmark_min_pts=4, max_clusters_per_scan=8,
                         ba_iterations=2, timer=timer)
    stages = ["odometry", "closures", "posegraph", "observations", "ba"]
    assert timed == stages
    (root,) = [s for s in rec.spans if s.parent is None]
    assert root.name == "slam"
    outer = _children(rec.spans, root)
    assert [s.name for s in outer] == ["timer." + n for n in stages]
    inner = [_children(rec.spans, s) for s in outer]
    assert [k[0].name for k in inner] == stages
    odometry = inner[0][0]
    icps = [s for s in _children(rec.spans, odometry) if s.name == "icp"]
    assert len(icps) == scans.shape[0] - 1
    assert all(s.root == root.id for s in rec.spans)


def test_spans_lie_on_the_profilers_clock():
    """Every operator of a span's body, as the profiler timed it, lies
    inside the span's [start, end]."""
    x = torch.arange(4096, dtype=torch.float64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        assert prof.on()
        with prof.span("body") as body:
            y = torch.cumsum(x, 0)
            z = torch.sort(y.flip(0)).values
            prof.sync(float, z[-1])
    assert float(z[-1]) == float(y[-1])
    events = p.profiler.kineto_results.events()
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in events if e.name() in ("aten::cumsum", "aten::sort",
                                           "aten::flip")]
    assert {n for n, _, _ in ops} == {"aten::cumsum", "aten::sort",
                                      "aten::flip"}
    for name, s, e in ops:
        assert body.start_ns <= s <= e <= body.end_ns, name
    (read,) = [s for s in prof.records() if s.parent == body.id]
    assert read.name == "sync" and _inside(read, body)
    assert body.counters == {"host_syncs": 1}


COLLECTIVES = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from vtkcloudpoint_tpu_torch.parallel.mesh import make_mesh
    from vtkcloudpoint_tpu_torch.utils import profiling as prof

    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    mesh = make_mesh(world, device="cpu")
    x = torch.arange(12, dtype=torch.float32) + rank
    with prof.recording() as rec:
        total = mesh.psum(x)
        flag = mesh.any(torch.tensor(rank == 1))
        gathered = mesh.all_gather(x)
        swapped = mesh.all_to_all(x.reshape(world, -1))
        hop = mesh.ppermute_ring(x)
    assert flag and torch.equal(total, 2 * x - rank + (1 - rank))
    assert torch.equal(gathered[rank], x)
    assert torch.equal(hop, x + (1 if rank == 0 else -1))
    assert swapped.shape == (world, 12 // world)
    with open(f"{out}.{rank}", "w") as f:
        json.dump([s.as_dict() for s in rec.spans], f)
    dist.destroy_process_group()
""")


def test_collectives_record_their_spans_and_bytes_on_two_gloo_ranks(
        tmp_path):
    from vtkcloudpoint_tpu_torch.parallel.distributed import free_port

    port, out = str(free_port()), str(tmp_path / "spans")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", COLLECTIVES, str(r),
                               "2", port, out], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    for p in procs:
        text = p.communicate(timeout=120)[0].decode()
        assert p.returncode == 0, text
    for rank in range(2):
        with open(f"{out}.{rank}") as f:
            spans = json.load(f)
        roots = [s for s in spans if s["parent"] is None]
        assert [s["name"] for s in roots] == [
            "collective.all_reduce", "collective.any",
            "collective.all_gather", "collective.all_to_all",
            "collective.ppermute_ring"]
        by = {s["name"]: s for s in roots}
        assert by["collective.all_reduce"]["counters"] == {"bytes": 48}
        assert by["collective.all_gather"]["counters"] == {"bytes": 48}
        assert by["collective.all_to_all"]["counters"] == {"bytes": 24}
        assert by["collective.ppermute_ring"]["counters"] == {"bytes": 48}
        anys = [s for s in spans if s["parent"] == by["collective.any"]["id"]]
        assert [s["name"] for s in anys] == ["collective.all_reduce", "sync"]
        assert anys[0]["counters"] == {"bytes": 4}
        assert by["collective.any"]["counters"] == {"host_syncs": 1}


def test_device_trace_writes_the_spans_beside_the_trace(tmp_path):
    logdir = tmp_path / "tr"
    with prof.device_trace(str(logdir)):
        with prof.span("outer"):
            with prof.span("inner"):
                prof.count("things", 3)
            prof.sync(int, torch.ones(8).sum())
    assert (logdir / "trace.json").is_file()
    with open(logdir / "spans.json") as f:
        spans = json.load(f)
    assert [s["name"] for s in spans] == ["outer", "inner", "sync"]
    outer, inner, read = spans
    assert set(outer) == {"name", "id", "parent", "root", "start_ns",
                          "end_ns", "counters"}
    assert outer["parent"] is None and outer["root"] == outer["id"]
    assert inner["parent"] == read["parent"] == outer["id"]
    assert inner["counters"] == {"things": 3}
    assert outer["counters"] == {"host_syncs": 1}
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= read["start_ns"] <= read["end_ns"] <= outer["end_ns"]
