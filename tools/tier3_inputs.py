"""Inputs and settings of the tier-3 phases, numpy only: chip_smoke.py drives
them through the PyTorch port on the GPU, tools/jax_reference_tier3.py
through the JAX package on the CPU.

- TIER3: the 5M-point job of benchmarks/tier3_scale.py (parity mode, full
  stage), its cloud ``tier3_scale.cloud(5_000_000, seed=3)``;
- NN: the grid-ICP case of benchmarks/tier3_nn_crossover.py at m = 100,000
  target points and 100,000 source points (``nn_inputs``);
- GRID_ENGINE: Engine.cluster_grid on the session of tools/engine_session.py;
  cell_cap 2048 is above the fullest eps-cell of that cloud (1,529 points),
  so the grid engine overflows nothing and is exact global DBSCAN;
- HALO: cluster_scan(halo_merge=True) on the tier-2 cloud of bench.py.

    from tools.tier3_inputs import TIER3, tier3_cloud, NN, nn_inputs
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# benchmarks/tier3_scale.py:24-39 and its step(): parity mode, full stage
TIER3 = dict(
    n_points=5_000_000,
    block_cap=1024,
    max_blocks=4883,              # ceil(5e6 / 1024)
    eps=0.004,
    min_pts=8,
    metric="l1_motor",
    noise_cap=65536,
    noise_cell_cap=64,
    max_clusters=12288,
    cluster_cap=1024,
    max_hull=32,
    shape_chunk_k=4096,
    icp_iterations=50,
    icp_chunk=1024,
)

# benchmarks/tier3_nn_crossover.py:28-41,72-82 at one target size
NN = dict(m=100_000, n_src=100_000, max_iterations=20, tol=1e-10,
          cell_cap=64, fallback_cap=4096, rot_z=0.08,
          t_true=(0.3, -0.2, 0.1))

GRID_ENGINE = dict(cell_cap=2048, max_clusters=4096)

HALO = dict(halo_cap=64)


def tier3_cloud(n: int = TIER3["n_points"]):
    """(motor f32 [n, 2], xyz f32 [n, 3], truth f32 [min(5120, n // 800),
    3], k_true) of benchmarks/tier3_scale.py (seed 3)."""
    bench_dir = os.path.join(ROOT, "benchmarks")
    if bench_dir not in sys.path:
        sys.path.insert(0, bench_dir)
    import tier3_scale  # numpy only at module level

    return tier3_scale.cloud(n, seed=3)


def nn_cell(m: int) -> float:
    """The crossover bench's cell size: ~10 target points per cell of the
    50 x 50 x 5 slab."""
    return max(0.25, (10.0 * (50.0 * 50.0 * 5.0) / m) ** (1.0 / 3.0))


def nn_inputs(m: int = NN["m"], n_src: int = NN["n_src"]):
    """(source f32 [n_src, 3], target f32 [m, 3]): the target a 50 x 50 x 5
    slab of uniform points from default_rng(0), the source target points
    moved by the inverse of a z-rotation of 0.08 rad and (0.3, -0.2, 0.1),
    plus 1 cm of Gaussian noise. The rotation is built and applied in
    float64 and rounded to float32 once."""
    rng = np.random.default_rng(0)
    c, s = np.cos(NN["rot_z"]), np.sin(NN["rot_z"])
    r_true = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    t_true = np.asarray(NN["t_true"], np.float32)
    tgt = (rng.uniform(0, 50, (m, 3)) * [1, 1, 0.1]).astype(np.float32)
    src_idx = rng.integers(0, m, n_src)
    moved = (tgt[src_idx] - t_true).astype(np.float64)
    src = (moved[:, 0:1] * r_true[0] + moved[:, 1:2] * r_true[1]
           + moved[:, 2:3] * r_true[2]).astype(np.float32)
    src += 0.01 * rng.standard_normal((n_src, 3)).astype(np.float32)
    return src, tgt
