"""Host reads of the device in one scan: the counter `host_syncs` of
utils/profiling.py: sync, which every read of a device value goes through,
summed over every span, mean over the traced scans."""
from portbench.lib.spans import counter


def read(ctx):
    return counter(ctx, "host_syncs")
