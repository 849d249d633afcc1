"""Label-propagation sweeps of the noise re-cluster (the counter `sweeps`
of cluster/dbscan.py: fixpoint, on the span `noise` of cluster/fusion.py:
merge_blocks and the spans it opened), one a read of the device, a scan."""
from portbench.lib.spans import counter


def read(ctx):
    return counter(ctx, "sweeps", under=("noise",))
