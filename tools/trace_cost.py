"""What the port's span recorder (utils/profiling.py) costs, and what it
records, on the benchmark's stream scan, Engine session and SLAM job.

    python3 tools/trace_cost.py [--seed N] [--rounds R] [--slam-rounds S]
                                [--rehearse]

Builds the jobs of portbench's ``scan500k.stream``, ``scan500k.session``
and ``slam100.loop`` cells (their configurations and pools, ``--seed``
drawing the order),
warms them, then times the same jobs in turns with recording off and
inside ``profiling.recording()`` (off, on, on, off): each a host clock from
the call to the synchronised result. Prints JSON lines:
  cost      the medians and quartiles of each side, ms, and on / off - 1;
  records   from the recorded jobs: spans and host syncs a job, host syncs
            and their waits by stage (the innermost named span outside
            ``sync``), noise sweeps and ICP iterations a scan, SLAM's host
            ms an ICP iteration outside its reads, the longest waits, and
            ICP iterations launched (the card's loop, no-ops included) and
            K3's launches a job (kernels/neighbor.launches);
  check     the cost of one recording-off check, ns.
``--rehearse`` runs them at the benchmark tests' CPU sizes on the CPU.
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _jobs(seed, rehearse):
    from portbench.lib import harness

    bench = harness.bench_file(ROOT)
    device = "cpu" if rehearse else "cuda"
    out = {}
    for cell in ("scan500k.stream", "scan500k.session", "slam100.loop"):
        _, cfg, traffic, _ = harness.cell_spec(bench, cell)
        if rehearse:
            from portbench.tests.conftest import TINY, TINY_TRAFFIC

            cfg = dict(cfg, **TINY[cfg["name"]])
            traffic = dict(traffic, **TINY_TRAFFIC[traffic["job"]])
        out[cell] = harness.job_class(traffic)(cfg, traffic, seed, device)
    return out, device


def _timed(call, sync):
    t0 = time.perf_counter()
    call()
    sync()
    return (time.perf_counter() - t0) * 1e3


def _quartiles(v):
    if len(v) < 2:
        return [v[0]] * 3
    q = statistics.quantiles(v, n=4)
    return [q[0], statistics.median(v), q[2]]


def _stage(span, by_id):
    """The innermost span above ``span`` that is not a read."""
    p = by_id.get(span.parent)
    while p is not None and p.name == "sync":
        p = by_id.get(p.parent)
    return p.name if p is not None else "(none)"


def _records(spans, jobs):
    by_id = {s.id: s for s in spans}
    reads = [s for s in spans if s.name == "sync"]
    syncs, waits = {}, {}
    for s in reads:
        k = _stage(s, by_id)
        syncs[k] = syncs.get(k, 0) + 1
        waits[k] = waits.get(k, 0.0) + s.duration_ns * 1e-6
    icp = {s.id: s for s in spans if s.name == "icp"}
    iters = sum(s.counters.get("iterations", 0) for s in icp.values())
    launched = sum(s.counters.get("launched", 0) for s in icp.values())
    icp_host = sum(s.duration_ns for s in icp.values()) * 1e-6
    icp_wait = sum(s.duration_ns for s in reads if s.parent in icp) * 1e-6
    noise = {s.id for s in spans if s.name == "noise"}
    sweeps = 0
    for s in spans:
        if s.id in noise or s.parent in noise:
            noise.add(s.id)
            sweeps += s.counters.get("sweeps", 0)
    longest = sorted(reads, key=lambda s: -s.duration_ns)[:8]
    return {
        "spans_a_job": len(spans) / jobs,
        "host_syncs_a_job": sum(s.counters.get("host_syncs", 0)
                                for s in spans) / jobs,
        "syncs_by_stage": {k: v / jobs for k, v in sorted(syncs.items())},
        "sync_wait_ms_by_stage": {k: v / jobs
                                  for k, v in sorted(waits.items())},
        "icp_iterations_a_job": iters / jobs,
        "icp_launched_a_job": launched / jobs,
        "icp_ms_a_job": icp_host / jobs,
        "icp_host_ms_per_iter": ((icp_host - icp_wait) / iters
                                 if iters else None),
        "icp_wait_ms_per_iter": icp_wait / iters if iters else None,
        "noise_sweeps_a_job": sweeps / jobs,
        "longest_waits_ms": [[_stage(s, by_id), s.duration_ns * 1e-6]
                             for s in longest],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1300000007)
    ap.add_argument("--rounds", type=int, default=3,
                    help="turns (off, on, on, off) of the stream's pool")
    ap.add_argument("--slam-rounds", type=int, default=1,
                    help="turns (off, on, on, off) of one SLAM job")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from vtkcloudpoint_tpu_torch.kernels import neighbor
    from vtkcloudpoint_tpu_torch.utils import profiling

    jobs, device = _jobs(args.seed, args.rehearse)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    scan, slam = jobs["scan500k.stream"], jobs["slam100.loop"]
    session = jobs["scan500k.session"]
    for job in jobs.values():
        job.warm()
    sync()
    plan = {"scan500k.stream": ([lambda k=k: scan.run(k)
                                 for k in scan.order], args.rounds),
            "scan500k.session": ([lambda k=k: session.run(k)
                                  for k in session.order], 1),
            "slam100.loop": ([lambda: slam.survey(slam.order[0])],
                             args.slam_rounds)}
    for cell, (calls, rounds) in plan.items():
        off, on, spans = [], [], []
        k3 = neighbor.launches
        for r in range(rounds):
            turn = ("off", "on", "on", "off") if r % 2 == 0 else \
                ("on", "off", "off", "on")
            for side in turn:
                for call in calls:
                    if side == "off":
                        off.append(_timed(call, sync))
                    else:
                        with profiling.recording() as rec:
                            on.append(_timed(call, sync))
                        spans += rec.spans
        lo, hi = _quartiles(off), _quartiles(on)
        print(json.dumps({"cost": cell, "device": device, "jobs_each": len(
            off), "off_ms_q1_med_q3": lo, "on_ms_q1_med_q3": hi,
            "on_over_off": hi[1] / lo[1] - 1}), flush=True)
        k3 = (neighbor.launches - k3) / (len(on) + len(off))
        print(json.dumps({"records": cell, **_records(spans, len(on)),
                          "k3_launches_a_job": k3}), flush=True)
        profiling.clear()
    from torch._C._autograd import _profiler_enabled

    n = 200000
    t0 = time.perf_counter_ns()
    for _ in range(n):
        profiling.span("x")
    t1 = time.perf_counter_ns()
    for _ in range(n):
        _profiler_enabled()
    t2 = time.perf_counter_ns()
    print(json.dumps({"check": "recording off", "span_ns": (t1 - t0) / n,
                      "profiler_enabled_ns": (t2 - t1) / n}))
    if device == "cuda":
        os.system("nvidia-smi --query-gpu=name,power.limit "
                  "--format=csv,noheader")


if __name__ == "__main__":
    main()
