"""Test harness config.

Tests run on a virtual 8-device CPU mesh (multi-chip sharding is validated
without TPU hardware, per SURVEY.md §4 test strategy) with x64 enabled so the
JAX engine can be compared bit-for-bit against the float64 NumPy oracles.
"""
import os
import sys

# NOTE: in this environment jax may be pre-imported before conftest runs, so
# JAX_PLATFORMS in os.environ is too late -- use jax.config.update instead.
# XLA_FLAGS is read at backend init (first device use), so setting it here
# still works as long as no jax op ran yet.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the PyTorch port's hand "
        "kernels); skips without one")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_blobs(rng, n_clusters=5, pts_per=40, noise=20, spread=0.01, box=1.0):
    """Synthetic motor-space scan: gaussian blobs + uniform noise."""
    centers = rng.uniform(0.1 * box, 0.9 * box, size=(n_clusters, 2))
    pts = [centers[i] + spread * rng.standard_normal((pts_per, 2)) for i in range(n_clusters)]
    pts.append(rng.uniform(0, box, size=(noise, 2)))
    out = np.concatenate(pts)
    perm = rng.permutation(len(out))
    return out[perm]
