"""Inputs and settings of the tier-4 SLAM phase, numpy only: chip_smoke.py
drives them through the PyTorch port on the GPU, tools/jax_reference_tier4.py
through the JAX package on the CPU.

- TIER4: the job of benchmarks/tier4_slam.py:10-58 -- 100 scans of 2,048
  points of a landmark-structured world (48 blobs and background) seen from
  a drifting loop, ICP odometry, loop closures, pose-graph Gauss-Newton and
  cluster-centroid bundle adjustment;
- SCAN2MAP: slam.scan2map.scan_to_map on the same scans at its defaults
  (voxel 0.2, map_capacity 16,384, so the grid NN with the brute fallback).

``tier4_scans()`` gives the benchmark's scans bit for bit. The benchmark
builds its trajectory with the JAX package's ``se3.rotz`` with x64 off: a
float32 rotation whose cos and sin come from XLA. Their float32 values are
pinned here (ROTZ_COS32, ROTZ_SIN32); tests/test_torch_slam.py checks them
against JAX.

    from tools.tier4_inputs import TIER4, SCAN2MAP, tier4_scans
"""
import numpy as np

TIER4 = dict(
    scans=100,
    points_per_scan=2048,
    landmarks=48,
    seed=0,
    icp_max_iterations=30,
    icp_tol=1e-10,
    loop_radius=3.0,
    gn_iterations=8,
    landmark_eps=0.5,
    landmark_min_pts=8,
    max_clusters_per_scan=64,
    ba_iterations=8,
)

SCAN2MAP = dict(voxel_size=0.2, map_capacity=16384, nn="auto")

# float32 cos and sin of float32(2 pi / 100) as XLA:CPU computes them (the
# benchmark's se3.rotz(2 * np.pi / S) with x64 off), as bit patterns
ROTZ_COS32 = np.uint32(1065320110).view(np.float32)
ROTZ_SIN32 = np.uint32(1031837777).view(np.float32)


def rotz32(s: int = TIER4["scans"]) -> np.ndarray:
    """The float32 [3, 3] rotation the benchmark composes per step (only
    S = 100 is pinned)."""
    if s != 100:
        raise ValueError("only the 100-scan rotation is pinned")
    c, sn = ROTZ_COS32, ROTZ_SIN32
    return np.array([[c, -sn, 0.0], [sn, c, 0.0], [0.0, 0.0, 1.0]],
                    np.float32)


def tier4_scans(s: int = TIER4["scans"], n: int = TIER4["points_per_scan"],
                n_landmarks: int = TIER4["landmarks"], rot=None):
    """(scans f32 [s, n, 3], valid bool [s, n], r_true f64 [s, 3, 3],
    t_true f64 [s, 3]) of benchmarks/tier4_slam.py, drawn in its order from
    default_rng(0). ``rot`` is the float32 step rotation (default rotz32)."""
    rng = np.random.default_rng(TIER4["seed"])
    marks = rng.uniform(-30, 30, size=(n_landmarks, 3)) * np.array(
        [1, 1, 0.2])
    per = (2 * n // 3) // n_landmarks
    blob = (marks[:, None, :]
            + 0.08 * rng.standard_normal((n_landmarks, per, 3))
            ).reshape(-1, 3)
    bg = rng.uniform(-30, 30, size=(n - len(blob), 3)) * np.array(
        [1, 1, 0.2])
    world = np.concatenate([blob, bg])
    step = rotz32(s) if rot is None else rot
    r_true = [np.eye(3)]
    t_true = [np.zeros(3)]
    for _ in range(1, s):
        r_true.append(r_true[-1] @ step)
        t_true.append(t_true[-1] + r_true[-1] @ np.array([0.5, 0, 0]))
    r_true = np.stack(r_true)
    t_true = np.stack(t_true)
    scans = np.stack([
        ((world - t_true[k]) @ r_true[k]
         + 0.002 * rng.standard_normal((n, 3)))
        for k in range(s)
    ]).astype(np.float32)
    return scans, np.ones((s, n), bool), r_true, t_true
