"""The harness driven on the CPU at the tests' sizes: the staged pass, a
traffic mix found by name, the control and the faults that must come out
as not correct."""
import json
import os
import shutil
import time

import pytest
import torch

from conftest import ROOT
from portbench.lib import check, harness
from portbench.lib.timing import StepTimer

SEED = 2**31 + 17


def run(bench, spec, trace=False, seconds=0.2):
    return harness.run_spec(bench, *spec, SEED, seconds, trace, "cpu",
                            time.perf_counter())


def test_staged_pass_gives_cluster_scans_labels(tiny):
    from vtkcloudpoint_tpu_torch.cluster.pipeline import cluster_scan

    cell, cfg, traffic, _ = tiny("scan500k.stream")
    job = harness.job_class(traffic)(cfg, dict(traffic, distinct=1),
                                     SEED, "cpu")
    timer = StepTimer(cuda=False)
    label = job.staged(timer)
    s = job.scans[0]
    res = cluster_scan(s.xyz, s.motor, s.valid, job.ecfg, mode=cfg["mode"],
                       max_blocks=cfg["max_blocks"], quirks=cfg["quirks"],
                       noise_capacity=cfg["noise_capacity"],
                       max_clusters=cfg["max_clusters"],
                       cluster_capacity=cfg["cluster_capacity"],
                       max_hull=cfg["max_hull"])
    assert torch.equal(label, res.label)
    assert int(res.n_clusters) > 3
    assert set(timer.wall) == {"partition", "dbscan", "fusion", "stats",
                               "bucket", "shapes", "icp"}


@pytest.mark.parametrize("name", ["scan500k.stream", "scan500k.cluster_only",
                                  "scan500k.session", "slam100.loop"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(bench, tiny, name, trace):
    res = run(bench, tiny(name), trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in harness.metrics_of(bench, name, trace)}
    got = set(res["metrics"])
    assert got <= want
    if not trace:
        assert got == want
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_new_mix_file_is_found_by_name(bench, tmp_path):
    """A cell added with nothing but data files runs without an edit to
    the harness."""
    root = tmp_path / "checkout"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(ROOT, "portbench", d),
                        root / "portbench" / d)
    with open(root / "portbench" / "traffic" / "stream.json") as f:
        mix = json.load(f)
    mix.update(distinct=1, sample=1)
    with open(root / "portbench" / "traffic" / "one_scan.json", "w") as f:
        json.dump(mix, f)
    with open(os.path.join(ROOT, "portbench", "configs",
                           "scan500k.json")) as f:
        cfg = json.load(f)
    cfg.update(n_points=4000, blobs=8, max_blocks=4, max_clusters=64)
    with open(root / "portbench" / "configs" / "scan500k.json", "w") as f:
        json.dump(cfg, f)
    cell = {"name": "scan500k.one_scan", "config": "scan500k",
            "traffic": "one_scan", "chips": 1, "why": "a test"}
    b = dict(bench, workloads=bench["workloads"] + [cell])
    for m in b["end_to_end"]:
        if "workloads" in m and "scan500k.stream" in m["workloads"]:
            m["workloads"] = m["workloads"] + [cell["name"]]
    spec = harness.cell_spec(b, cell["name"], root=str(root))
    assert spec[2]["distinct"] == 1
    res = harness.run_spec(b, *spec, SEED, 0.1, False, "cpu",
                           time.perf_counter())
    assert res["correct"]
    assert "scan_points_per_s" in res["metrics"]


def control_verdict(tiny, name, device):
    cell, cfg, traffic, limits = tiny(name)
    job = harness.job_class(traffic)(cfg, traffic, SEED, device)
    ref = job.reference(0)
    readings = job.readings(job.lowered(0, ref), ref)
    return check.verdict(readings, limits)


@pytest.mark.parametrize("name", ["scan500k.stream", "scan500k.cluster_only",
                                  "scan500k.session"])
def test_the_control_is_not_correct(tiny, name):
    """The reference in the program's place, in the lower precision: at
    least one number over its limit (the bfloat16 stages; TF32 exists on
    the card only)."""
    ok, checks = control_verdict(tiny, name, "cpu")
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scan500k.stream", "scan500k.session",
                                  "slam100.loop"])
def test_the_control_is_not_correct_on_the_card(tiny, card, name):
    ok, checks = control_verdict(tiny, name, card)
    assert not ok, checks


# ---- faults planted in the timed path ----------------------------------------

def icp_unchanged(mod, name):
    """The ICP that returns the state it started from (no iteration)."""
    import dataclasses

    real = getattr(mod, name)

    def icp(*args, **kw):
        args = list(args)
        if len(args) > 4:
            args[4] = dataclasses.replace(args[4], max_iterations=0)
        else:
            kw["cfg"] = dataclasses.replace(kw["cfg"], max_iterations=0)
        return real(*args, **kw)

    return icp


def stats_over_half(real):
    """cluster_stats with half of the points left out, the mean taken over
    the rest."""
    def stats(xyz, motor, label, valid, *a, **kw):
        half = valid.clone()
        half[::2] = False
        return real(xyz, motor, label, half, *a, **kw)

    return stats


def label_altered(real):
    """cluster_scan with one point's label altered where it is produced."""
    def cluster_scan(*a, **kw):
        res = real(*a, **kw)
        label = res.label.clone()
        label[0] = label[0] + 1
        return res._replace(label=label)

    return cluster_scan


def poses_altered(real):
    """slam_pipeline_ba with one pose of each trajectory moved 5 cm (a
    sound float32 run lies up to 1.5 mm from the float64 one)."""
    def pipeline(*a, **kw):
        out = real(*a, **kw)
        moved = []
        for tr in out[:3]:
            t = tr.t.clone()
            t[-1, 0] += 5e-2
            moved.append(tr._replace(t=t))
        return (*moved, out[3])

    return pipeline


def matches_altered(real):
    def match(self, *a, **kw):
        out = dict(real(self, *a, **kw))
        idx = out["match_idx"].clone()
        idx[1] = idx[1] + 1
        out["match_idx"] = idx
        return out

    return match


def export_fewer_decimals(real):
    """An Engine that exports its centroids at 2 decimals, not 4."""
    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.export_bit = 2

    return init


def plant(monkeypatch, fault):
    from vtkcloudpoint_tpu_torch import engine
    from vtkcloudpoint_tpu_torch.cluster import pipeline
    from vtkcloudpoint_tpu_torch.register import icp
    from vtkcloudpoint_tpu_torch.slam import trajectory

    if fault == "scan_icp_unchanged":
        monkeypatch.setattr(icp, "icp", icp_unchanged(icp, "icp"))
    elif fault == "scan_stats_over_half":
        monkeypatch.setattr(pipeline, "cluster_stats",
                            stats_over_half(pipeline.cluster_stats))
    elif fault == "scan_label_altered":
        monkeypatch.setattr(pipeline, "cluster_scan",
                            label_altered(pipeline.cluster_scan))
    elif fault == "session_icp_unchanged":
        monkeypatch.setattr(engine, "icp", icp_unchanged(engine, "icp"))
    elif fault == "session_stats_over_half":
        monkeypatch.setattr(pipeline, "cluster_stats",
                            stats_over_half(pipeline.cluster_stats))
    elif fault == "session_match_altered":
        monkeypatch.setattr(engine.Engine, "match",
                            matches_altered(engine.Engine.match))
    elif fault == "session_export_fewer_decimals":
        monkeypatch.setattr(engine.Engine, "__init__",
                            export_fewer_decimals(engine.Engine.__init__))
    elif fault == "slam_icp_unchanged":
        monkeypatch.setattr(trajectory, "icp",
                            icp_unchanged(trajectory, "icp"))
    elif fault == "slam_pose_altered":
        monkeypatch.setattr(trajectory, "slam_pipeline_ba",
                            poses_altered(trajectory.slam_pipeline_ba))


FAULTS = [("scan500k.stream", "scan_icp_unchanged"),
          ("scan500k.stream", "scan_stats_over_half"),
          ("scan500k.stream", "scan_label_altered"),
          ("scan500k.cluster_only", "scan_stats_over_half"),
          ("scan500k.cluster_only", "scan_label_altered"),
          ("scan500k.session", "session_icp_unchanged"),
          ("scan500k.session", "session_stats_over_half"),
          ("scan500k.session", "session_match_altered"),
          ("scan500k.session", "session_export_fewer_decimals"),
          ("slam100.loop", "slam_icp_unchanged"),
          ("slam100.loop", "slam_pose_altered")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(bench, tiny, monkeypatch,
                                                  name, fault):
    """A run whose timed path is broken underneath comes out not correct.
    The cells run on one chip: there is no exchange between chips to leave
    out."""
    plant(monkeypatch, fault)
    res = run(bench, tiny(name))
    assert not res["correct"], res["checks"]
