"""The readings that the limits of ``correct`` are set from: the program's
on many seeds, a sound witness's (the float stages in float64,
plainref/chains.py) on many, and the control's (the reference computed in
the nearest lower precision) on a few.

    python portbench/control.py --workload scan500k.stream \
        --seeds 11,12,13 --witness-seeds 31,32,33 \
        --control-seeds 21,22,23 --out readings.json

For each program seed a pool drawn from that seed runs once through the
timed entry point (every scan, session or survey of the pool, and the
seed's own input that the set-up runs) and every output is compared with
the reference; for each witness or control seed, that one takes the
program's place (``--jobs`` inputs of the pool each). Prints, and writes
to ``--out``, each seed's readings, the largest program or witness reading
of each number (the lower reading) and the smallest control reading (the
upper one). The benchmark's own runs do not run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def program_readings(job, n_jobs):
    outs = [job.warm()]
    for i in range(n_jobs):
        outs.append(getattr(job, "keep", lambda x: x)(job(i)))
    out = []
    for o in outs:
        ref = job.reference(getattr(o, "scan", 0))
        r = job.readings(job.as_compared(o), ref)
        r["failed"] = job.failed(o)
        out.append(r)
    return out


def stand_in_readings(stand_in):
    def readings(job, n_jobs):
        out = []
        for k in range(n_jobs):
            ref = job.reference(k)
            out.append(job.readings(getattr(job, stand_in)(k, ref), ref))
        return out

    return readings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--witness-seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--jobs", type=int, default=0,
                    help="inputs a witness or control seed compares "
                         "(default: the whole pool)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.lib import harness

    bench = harness.bench_file(ROOT)
    cell, cfg, traffic, limits = harness.cell_spec(bench, args.workload)
    Job = harness.job_class(traffic)
    n_jobs = traffic["distinct"]
    n_stand_in = args.jobs or n_jobs
    res = {"workload": args.workload, "program": {}, "witness": {},
           "control": {}}
    for kind, group, fn, n in (
            ("program", args.seeds, program_readings, n_jobs),
            ("witness", args.witness_seeds, stand_in_readings("witness"),
             n_stand_in),
            ("control", args.control_seeds, stand_in_readings("lowered"),
             n_stand_in)):
        for seed in group:
            t0 = time.perf_counter()
            # each seed its own pool, so the readings cover many inputs
            job = Job(cfg, dict(traffic, pool_seed=seed), seed, args.device)
            res[kind][seed] = fn(job, n)
            print(json.dumps({kind: seed, "s": time.perf_counter() - t0,
                              "readings": res[kind][seed]}), flush=True)
            del job
    names = sorted(limits)
    lower = {n: max((r[n] for kind in ("program", "witness")
                     for v in res[kind].values() for r in v if n in r),
                    default=None) for n in names}
    upper = {n: min((r[n] for v in res["control"].values() for r in v
                     if n in r), default=None) for n in names}
    res["lower"], res["upper"], res["limits"] = lower, upper, limits
    print(json.dumps({"lower": lower, "upper": upper, "limits": limits}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
