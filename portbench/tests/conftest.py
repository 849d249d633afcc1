"""Shared fixtures of the benchmark's own tests (CPU; a test marked
``cuda`` skips without a card)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the sizes of the CPU tests: a few thousand points, a dozen scans
TINY = {
    "scan500k": dict(n_points=6000, blobs=12, max_blocks=6, max_clusters=64),
    "slam100": dict(scans=12, points_per_scan=256, landmarks=8,
                    max_clusters_per_scan=16),
}
TINY_TRAFFIC = {"scan": dict(distinct=2),
                "session": dict(capacity=6144, distinct=2),
                "slam": dict(distinct=2)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture(autouse=True)
def own_tmpdir(tmp_path, monkeypatch):
    """Runs write their exports under the test's own temporary directory."""
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


@pytest.fixture
def bench():
    from portbench.lib import harness

    return harness.bench_file(ROOT)


@pytest.fixture
def tiny(bench):
    """tiny(workload) -> (cell, cfg, traffic, limits) at the CPU tests'
    sizes."""
    from portbench.lib import harness

    def make(name):
        cell, cfg, traffic, limits = harness.cell_spec(bench, name)
        cfg = dict(cfg, **TINY[cfg["name"]])
        traffic = dict(traffic, **TINY_TRAFFIC[traffic["job"]])
        return cell, cfg, traffic, limits

    return make


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
