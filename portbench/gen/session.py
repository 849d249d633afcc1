"""The Engine session's scan: the tier-2 cloud given ranges.

Copied from the repository's Engine session generator
(``tools/engine_session.py``), seeded by numpy generators instead of fixed
seeds:

- motor angles and the blob centres come from ``gen.cloud``;
- every blob gets one range, uniform in ``blob_range``, and each of its
  points that range plus ``range_sigma`` of gaussian noise;
- the other points get uniform ranges in ``noise_range``; ``gate_zero`` of
  them read 0 and ``gate_far`` read ``far_range``, which the import's
  range gate drops; the last ``duplicates`` rows repeat the first ones
  exactly, which the import's dedup collapses;
- the truth is the forward formula of the default rig (xdir 2, ydir 1, no
  boresight offset) applied in float64 to the blob centres at their blob's
  range, stored as float32.
"""
import numpy as np

from .cloud import synthetic_cloud


def forward_xyz(motor, rng):
    """Motor angles (degrees) and range to XYZ for the default rig, in
    float64."""
    motor = np.asarray(motor, np.float64)
    rng = np.asarray(rng, np.float64)
    pitch = -2.0 * motor[:, 0] / 180.0 * np.pi
    az = 2.0 * motor[:, 1] / 180.0 * np.pi
    x = rng * np.cos(pitch) * np.sin(az)
    y = rng * np.sin(pitch) * np.cos(az)
    z = rng * np.cos(pitch)
    return np.stack([x, y, z], axis=-1)


def session_scan(rng_cloud, rng_range, cloud: dict, session: dict):
    """(motor f32 [n, 2], range f32 [n], truth_xyz f32 [blobs, 3])."""
    n, k = cloud["n_points"], cloud["blobs"]
    motor, _, truth, _ = synthetic_cloud(
        rng_cloud, n, k, cloud["blob_sigma"], cloud["noise_frac"],
        cloud["n_truth"])
    per = (n - int(n * cloud["noise_frac"])) // k
    blob_range = rng_range.uniform(*session["blob_range"], k)
    dist = np.empty(n)
    dist[:per * k] = (np.repeat(blob_range, per) + session["range_sigma"]
                      * rng_range.standard_normal(per * k))
    dist[per * k:] = rng_range.uniform(*session["noise_range"], n - per * k)
    z0, zf = session["gate_zero"], session["gate_far"]
    dist[per * k:per * k + z0] = 0.0
    dist[per * k + z0:per * k + z0 + zf] = session["far_range"]
    d = session["duplicates"]
    motor[-d:] = motor[:d]
    dist[-d:] = dist[:d]
    truth_xyz = forward_xyz(truth[:, :2], blob_range[:len(truth)])
    return motor, dist.astype(np.float32), truth_xyz.astype(np.float32)
