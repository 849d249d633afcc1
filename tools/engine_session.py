"""The Engine session at users' scale, numpy only: the scan that
chip_smoke.py drives through the port's Engine on the GPU and that
tools/jax_reference_engine.py drives through the JAX package's Engine on the
CPU.

- motor angles and the 450 marker centres come from bench.synthetic_cloud
  (500,000 points: 450 blobs of 0.0008 deg plus 0.6% uniform noise);
- every blob gets one range from default_rng(1).uniform(40, 45), and each
  of its points that range plus 1 mm of Gaussian noise;
- noise points get uniform ranges in [5, 120] m, so the 10-100 m distance
  window drops some of them; 16 of them read 0 and 16 read 1500 m, which the
  import range gate drops; the last 64 rows repeat the first 64 exactly,
  which the import dedup collapses (mult 2);
- the truth is the forward formula of data/convert.py (default rig: xdir 2,
  ydir 1, no boresight offset) applied in float64 to the marker centres at
  their blob's range, stored as float32.

    from tools.engine_session import SESSION, engine_session, engine_config
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the run both Engines make (chip_smoke.py, tools/jax_reference_engine.py)
SESSION = dict(
    n_points=500_000,
    capacity=500_736,            # 489 blocks of 1024
    dis_min=10.0, dis_max=100.0,
    cluster=dict(mode="balanced", max_blocks=489, max_clusters=1024,
                 cluster_capacity=1024, noise_capacity=4096),
    reject_radius=0.0055,        # metres: 4% from every radius; rejects
                                 # the clusters that took mixed-range noise
    num_starts=4,
    ransac_iters=64,
)


def engine_config(config=None, **icp):
    """EngineConfig of the session: eps 0.004 motor-L1, min_pts 8, block
    capacity 1024; ``icp`` overrides ICPConfig fields. ``config`` is the
    module of the dataclasses: the port's (the default) or the JAX
    package's ``vtkcloudpoint_tpu.config``, which holds the same fields."""
    if config is None:
        from vtkcloudpoint_tpu_torch import config

    return config.EngineConfig(
        cluster=config.ClusterConfig(eps=0.004, min_pts=8,
                                     block_capacity=1024),
        icp=config.ICPConfig(**icp))


def forward_xyz(motor, rng):
    """data/convert.py's motor_to_xyz for the default rig, in float64."""
    motor = np.asarray(motor, np.float64)
    rng = np.asarray(rng, np.float64)
    pitch = -2.0 * motor[:, 0] / 180.0 * np.pi
    az = 2.0 * motor[:, 1] / 180.0 * np.pi
    x = rng * np.cos(pitch) * np.sin(az)
    y = rng * np.sin(pitch) * np.cos(az)
    z = rng * np.cos(pitch)
    return np.stack([x, y, z], axis=-1)


def engine_session(n: int = SESSION["n_points"]):
    """(motor f32 [n, 2], rng f32 [n], truth_xyz f32 [450, 3])."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import bench

    motor, _, truth = bench.synthetic_cloud(n)
    k = len(truth)
    per = (n - int(n * 0.006)) // k        # bench.synthetic_cloud's blobs
    r = np.random.default_rng(1)
    blob_range = r.uniform(40.0, 45.0, k)
    rng = np.empty(n)
    rng[:per * k] = (np.repeat(blob_range, per)
                     + 0.001 * r.standard_normal(per * k))
    rng[per * k:] = r.uniform(5.0, 120.0, n - per * k)
    rng[per * k:per * k + 16] = 0.0
    rng[per * k + 16:per * k + 32] = 1500.0
    motor[-64:] = motor[:64]
    rng[-64:] = rng[:64]
    truth_xyz = forward_xyz(truth[:, :2], blob_range)
    return motor, rng.astype(np.float32), truth_xyz.astype(np.float32)
