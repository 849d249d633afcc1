"""The metrics that read the program's own spans and counters
(lib/spans.py): each is read, with a value, in the traced CPU dry run of
every cell its entry names."""
import time

import pytest

from portbench.lib import harness

SEED = 2**31 + 29
SCAN = ("partition_span_ms.scan", "fusion_span_ms.scan",
        "noise_sweeps.scan", "segment_span_ms.scan", "host_syncs.scan")
SPAN_METRICS = {
    "scan500k.stream": SCAN + ("icp_span_ms.scan", "icp_iterations.scan"),
    "scan500k.cluster_only": SCAN,
    "scan500k.session": ("import_span_ms.session",
                         "register_span_ms.session", "host_syncs.session"),
    "slam100.loop": ("host_syncs.slam", "icp_host_ms_per_iter.slam"),
}


def test_the_entries_name_these_cells(bench):
    entries = {m["name"]: m for m in bench["per_layer"]}
    for cell, names in SPAN_METRICS.items():
        for n in names:
            assert cell in entries[n]["workloads"], (n, cell)
            assert entries[n]["source"] in ("program_span",
                                            "program_counter")


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_each_span_metric_is_read_in_its_cells(bench, tiny, name):
    res = harness.run_spec(bench, *tiny(name), SEED, 0.2, True, "cpu",
                           time.perf_counter())
    assert res["correct"]
    got = {m: res["metrics"][m]["value"] for m in SPAN_METRICS[name]}
    assert all(v > 0 for v in got.values()), got
    if name == "scan500k.stream":
        # the convergence flag and the Horn solve read the card every
        # iteration
        assert got["host_syncs.scan"] > 2 * got["icp_iterations.scan"]
