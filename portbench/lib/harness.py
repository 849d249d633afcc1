"""One run of one cell: set-up, the measured window (or the traced pass),
the comparison with the plain reference, the metrics and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (its
``job`` names the module ``jobs/<job>.py``), ``limits/<config>.<job>.json``
and ``metrics/<metric>.py`` (a reader with ``read(ctx)``, returning a
number or None where it finds nothing to read).

What is compared: a sample of the window's outputs drawn from the seed (or
every output of the traced pass), and the output of the set-up's last warm
job, which ran the timed path on an input drawn from the seed outside the
window's pool. The run refuses to give a result if JAX or the JAX package
was loaded at any point up to the result.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import random
import sys
import time
from types import SimpleNamespace

from . import check
from .timing import StepTimer, Window

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "vtkcloudpoint_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def bench_file(root):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_spec(bench: dict, name: str, root: str = ROOT):
    """(cell, config, traffic, limits) of the workload ``name``, read from
    the checkout at ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = os.path.join(root, "portbench")
    cfg = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(here, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(
        here, "limits", f"{cell['config']}.{traffic['job']}.json"))
    return cell, cfg, traffic, limits


def job_class(traffic: dict):
    return importlib.import_module(f"portbench.jobs.{traffic['job']}").Job


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of portbench/metrics/<metric>.py."""
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, trace: bool):
    """The cell's metrics: its end-to-end ones untraced, its per-layer ones
    traced (a metric with no ``workloads`` key belongs to every cell)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules():
    """Top-level names of loaded modules that the run must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of ``k`` items from a stream, seeded."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item, keep=lambda item: item) -> None:
        """Offer ``item``; ``keep(item)`` is what is held, called only for
        an item taken into the sample."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(keep(item))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = keep(item)


def launches():
    """The program's kernel launch counters (one a wrapper call)."""
    from vtkcloudpoint_tpu_torch.kernels import dbscan, neighbor, shapes

    return {"k1_launches": dbscan.launches, "k2_launches": shapes.launches,
            "k3_launches": neighbor.launches}


def add_work(total: dict, work: dict) -> None:
    for k, (ops, nbytes) in work.items():
        o, b = total.get(k, (0, 0))
        total[k] = (o + ops, b + nbytes)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, log=sys.stderr):
    """One run of the workload ``name``; returns the result dict (the
    line's keys, ``checks`` last)."""
    return run_spec(bench, *cell_spec(bench, name), seed, seconds, trace,
                    device, t_start, log)


def run_spec(bench: dict, cell: dict, cfg: dict, traffic: dict,
             limits: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=sys.stderr):
    """One run of ``cell`` at the configuration ``cfg``, the traffic
    ``traffic`` and the limits ``limits`` (run_cell reads them from their
    files; the tests pass small ones)."""
    import torch

    name = cell["name"]
    Job = job_class(traffic)
    cuda = torch.device(device).type == "cuda"
    job = Job(cfg, traffic, seed, device)
    own = job.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    ctx = SimpleNamespace(cell=cell, cfg=cfg, traffic=traffic,
                          setup_s=setup_s, window=None, units=[], spans={},
                          counters={}, trace=None,
                          traced_jobs=0, work={})
    attempted = failed = 0
    keep = getattr(job, "keep", lambda out: out)
    sample = Reservoir(traffic.get("sample", 1), seed)
    breakdown = None
    if not trace:
        def record(i, out, err):
            nonlocal failed
            why = err if err is not None else job.failed(out)
            if why is not None:
                failed += 1
                print(f"job {i} failed: {why}", file=log)
                return
            ctx.units.append(job.units(out))
            sample.offer((i, out), lambda item: (item[0], keep(item[1])))

        win = Window(seconds).run(job, record)
        ctx.window = win
        lat = sorted(x * 1e3 for x in win.latencies)
        print(f"window: {win.window_s:.3f} s, {win.attempted} jobs, latency "
              f"ms min {lat[0]:.3f} median {lat[len(lat) // 2]:.3f} max "
              f"{lat[-1]:.3f}; first three "
              f"{[round(x * 1e3, 3) for x in win.latencies[:3]]}", file=log)
        attempted = win.attempted
        kept = sample.items
    else:
        from .trace import Traced

        n_jobs = traffic.get("traced", traffic["distinct"])
        before = launches() if cuda else {}
        timer = StepTimer(cuda=cuda)
        with Traced(cuda) as tr:
            # each session's export is read before the next rewrites it
            kept = [(i, keep(job.traced(i, tr.mark))) for i in range(n_jobs)]
        outs = list(kept)
        after = launches() if cuda else {}
        ctx.counters = {k: (after[k] - before[k]) / n_jobs for k in after}
        ctx.trace, ctx.traced_jobs = tr, n_jobs
        print(f"trace: {tr.n_device_events} device events, clock offset "
              f"{tr.clock_offset_ms:.3f} ms, stop {tr.stop_s:.2f} s, read "
              f"{tr.read_s:.2f} s", file=log)
        job.staged(timer)
        ctx.spans = timer.wall
        attempted = n_jobs
        for i, out in outs:
            why = job.failed(out)
            if why is not None:
                failed += 1
                print(f"job {i} failed: {why}", file=log)
        breakdown = {"device_ops": tr.device_ops,
                     "idle_gaps": tr.idle_gaps}

    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the comparison: every kept output, and the set-up's job on the
    # seed's own input, against the reference's own answer
    why = job.failed(own)
    if why is not None:
        failed += 1
        print(f"the set-up's job on the seed's own input failed: {why}",
              file=log)
    kept.append(("own", own))
    per, refs = [], {}
    for i, out in kept:
        k = getattr(out, "scan", 0)
        if k not in refs:
            refs[k] = job.reference(k)
        per.append(job.readings(job.as_compared(out), refs[k]))
        if trace and i != "own":
            # the rooflines count the traced jobs' work alone
            add_work(ctx.work, job.work(k, refs[k]))
    del kept
    readings = check.worst(per) if per else {}
    correct, checks = check.verdict(readings, limits)
    correct = correct and failed == 0 and bool(per)

    metrics = {}
    for m in metrics_of(bench, name, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
    # last, once the reference and the readers have run too
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: the run loaded {', '.join(found)}; "
                         "nothing of JAX or the JAX package may load")
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
