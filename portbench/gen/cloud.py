"""The tier-2 scan: a dense blob field in motor coordinates.

Copied from the synthetic cloud of the repository's tier-2 benchmark
(``bench.py: synthetic_cloud``), seeded by a numpy generator instead of a
fixed seed. ``blobs`` gaussian blobs of ``sigma`` (motor units) with
centres uniform in [0.02, 0.98]^2 hold all but ``noise_frac`` of the
points; the rest, and the remainder of the even split, are uniform in
[0, 1]^2. The truth points are the blob centres at z = 1, the first
``n_truth`` of them.
"""
import numpy as np


def synthetic_cloud(rng, n: int, blobs: int, sigma: float, noise_frac: float,
                    n_truth: int):
    """(motor f32 [n, 2], xyz f32 [n, 3], truth f32 [min(blobs, n_truth), 3],
    centres f64 [blobs, 2])."""
    n_noise = int(n * noise_frac)
    n_clustered = n - n_noise
    centers = rng.uniform(0.02, 0.98, size=(blobs, 2))
    per = n_clustered // blobs
    pts = [centers[i] + sigma * rng.standard_normal((per, 2))
           for i in range(blobs)]
    pts.append(rng.uniform(0, 1, size=(n_clustered - per * blobs, 2)))
    pts.append(rng.uniform(0, 1, size=(n_noise, 2)))
    motor = np.concatenate(pts)[:n].astype(np.float32)
    xyz = np.concatenate([motor, np.ones((n, 1), np.float32)], axis=1)
    truth = np.concatenate([centers, np.ones((blobs, 1))],
                           axis=1).astype(np.float32)[:n_truth]
    return motor, xyz, truth, centers
