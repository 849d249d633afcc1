"""The tier-4 survey: scans of a landmark world from a drifting loop.

Copied from the repository's tier-4 benchmark (``benchmarks/tier4_slam.py``
and ``tools/tier4_inputs.py``), seeded by a numpy generator instead of a
fixed seed, and with the step rotation computed by numpy in float64 (the
copied generator pinned the float32 bits of another library's cosine).

``landmarks`` blobs (sigma ``blob_sigma``) hold two thirds of each scan's
``points`` world points, uniform background the rest; the world box is
[-30, 30]^2 x [-6, 6]. The scanner drives ``step`` metres a scan and turns
2 pi / scans, so the path closes a loop; each scan sees the whole world in
its own frame with ``noise`` of gaussian noise.
"""
import numpy as np


def rotz(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def survey(rng, scans: int, points: int, landmarks: int, blob_sigma: float,
           step: float, noise: float):
    """(scans f32 [S, N, 3], valid bool [S, N], r_true f64 [S, 3, 3],
    t_true f64 [S, 3])."""
    box = np.array([1.0, 1.0, 0.2])
    marks = rng.uniform(-30, 30, size=(landmarks, 3)) * box
    per = (2 * points // 3) // landmarks
    blob = (marks[:, None, :]
            + blob_sigma * rng.standard_normal((landmarks, per, 3))
            ).reshape(-1, 3)
    bg = rng.uniform(-30, 30, size=(points - len(blob), 3)) * box
    world = np.concatenate([blob, bg])
    turn = rotz(2 * np.pi / scans)
    r_true, t_true = [np.eye(3)], [np.zeros(3)]
    for _ in range(1, scans):
        r_true.append(r_true[-1] @ turn)
        t_true.append(t_true[-1] + r_true[-1] @ np.array([step, 0.0, 0.0]))
    r_true, t_true = np.stack(r_true), np.stack(t_true)
    out = np.stack([(world - t_true[k]) @ r_true[k]
                    + noise * rng.standard_normal((points, 3))
                    for k in range(scans)]).astype(np.float32)
    return out, np.ones((scans, points), bool), r_true, t_true
