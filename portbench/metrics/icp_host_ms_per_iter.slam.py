"""Host ms of one ICP iteration in the SLAM job outside its reads of the
device: the spans `icp` of register/icp.py: icp_loop less their `sync`
children, over the counter `iterations` of those spans."""
from portbench.lib.spans import traced_spans


def read(ctx):
    spans = traced_spans(ctx)
    icp = {s.id: s for s in spans or () if s.name == "icp"}
    iters = sum(s.counters.get("iterations", 0) for s in icp.values())
    if not iters:
        return None
    host = sum(s.end_ns - s.start_ns for s in icp.values())
    wait = sum(s.end_ns - s.start_ns for s in spans
               if s.name == "sync" and s.parent in icp)
    return (host - wait) * 1e-6 / iters
