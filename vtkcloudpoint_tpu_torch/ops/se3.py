"""SE(3) utilities: Horn quaternion / Kabsch SVD closed-form rigid alignment
and the SO(3) exponential and logarithm (port of vtkcloudpoint_tpu.ops.se3).

The correct Horn/Kabsch maths, not the managed reference's bugs B1-B3
(docs/PARITY.md). Matmuls run in full float32 (device.py turns TF32 off).
"""
from __future__ import annotations

import torch

from .. import device as _device  # noqa: F401  (full-f32 matmuls)
from ..utils import profiling as prof


def quat_to_rot(q):
    """Unit quaternion (w, x, y, z) -> 3x3 rotation (ICP.cs:274-285 layout)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z,
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     w * w - x * x - y * y + z * z]),
    ])


def horn_from_moments(sw, sp, sy, spy):
    """Horn solve from weighted moment sums: sw = sum w, sp = sum w p,
    sy = sum w y, spy = sum w p y^T. The 4x4 symmetric N-matrix's top
    eigenvector is the rotation quaternion."""
    if isinstance(sw, torch.Tensor):
        sw = torch.as_tensor(sw, dtype=spy.dtype, device=spy.device)
    else:                                   # a copy from the host
        sw = prof.sync(torch.as_tensor, sw, dtype=spy.dtype,
                       device=spy.device)
    sw = torch.clamp_min(sw, 1e-30)
    mean_p = sp / sw
    mean_y = sy / sw
    m = spy / sw - torch.outer(mean_p, mean_y)
    a = m - m.T
    delta = torch.stack([a[1, 2], a[2, 0], a[0, 1]])   # A[0,1], not B2
    tr = torch.trace(m)
    q_mat = torch.zeros((4, 4), dtype=spy.dtype, device=spy.device)
    q_mat[0, 0] = tr
    q_mat[0, 1:] = delta
    q_mat[1:, 0] = delta
    q_mat[1:, 1:] = m + m.T - tr * torch.eye(3, dtype=spy.dtype,
                                             device=spy.device)
    evals, evecs = prof.sync(torch.linalg.eigh, q_mat)   # its error check
    q = prof.sync(lambda: evecs[:, torch.argmax(evals)])
    r = quat_to_rot(q)
    return r, mean_y - r @ mean_p


def _weighted_means(p, y, weights):
    if weights is None:
        weights = torch.ones(p.shape[0], dtype=p.dtype, device=p.device)
    wsum = torch.clamp_min(weights.sum(), 1e-30)
    wn = (weights / wsum)[:, None]
    return wn, (p * wn).sum(dim=0), (y * wn).sum(dim=0)


def horn_solve(p, y, weights=None):
    """(R, t) minimising sum w ||R p + t - y||^2 for [N, 3] pairs (Horn's
    quaternion method on the centred, weighted cross-covariance)."""
    wn, mean_p, mean_y = _weighted_means(p, y, weights)
    m = ((p - mean_p) * wn).T @ (y - mean_y)
    zero3 = torch.zeros(3, dtype=p.dtype, device=p.device)
    r, _ = horn_from_moments(1.0, zero3, zero3, m)
    return r, mean_y - r @ mean_p


def kabsch_solve(p, y, weights=None):
    """Rigid alignment via SVD (Kabsch/Umeyama), the vtkLandmarkTransform
    RigidBody equivalent."""
    wn, mean_p, mean_y = _weighted_means(p, y, weights)
    h = ((p - mean_p) * wn).T @ (y - mean_y)
    u, _, vt = prof.sync(torch.linalg.svd, h)       # its error check
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    s = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    r = vt.T @ s @ u.T
    return r, mean_y - r @ mean_p


def apply_rigid(r, t, pts):
    """x -> R x + t for [N, 3] points."""
    return pts @ r.T + t


def compose(r1, t1, r0, t0):
    """(r1, t1) o (r0, t0): apply (r0, t0) first."""
    return r1 @ r0, r1 @ t0 + t1


def to_matrix4(r, t):
    """4x4 homogeneous matrix (vtk icp.GetMatrix() layout, FrmMain.cs:862)."""
    bottom = torch.zeros((1, 4), dtype=r.dtype, device=r.device)
    bottom[0, 3] = 1.0
    return torch.cat([torch.cat([r, t[:, None]], dim=1), bottom])


def rotz(theta):
    theta = torch.as_tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z]), torch.stack([s, c, z]),
                        torch.stack([z, z, o])])


def so3_hat(w):
    """[3] -> skew-symmetric [3, 3]."""
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def so3_exp(w):
    """Rodrigues: rotation vector [3] -> R [3, 3] (Taylor-safe near 0).

    Double-where guard: inside the small region the sqrt's INPUT is
    replaced by 1, not just its output, so forward-mode Jacobians stay
    finite at w = 0 (d sqrt(w.w) is inf there, and inf * 0 is NaN). The
    guard constants are float32-representable."""
    theta2 = torch.dot(w, w)
    small = theta2 <= 1e-12
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2s)
    k = so3_hat(w)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * k + b * (k @ k)


def so3_log(r):
    """R [3, 3] -> rotation vector [3], angle in [0, pi).

    atan2 form with a Taylor branch, so Jacobians stay finite at theta -> 0
    (an arccos form has an infinite derivative there); the sqrt's input is
    replaced inside the small region as in so3_exp. Angles at exactly pi
    are degenerate (w ~= 0)."""
    w = torch.stack([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    n2 = torch.dot(w, w)
    small = n2 < 1e-12
    n2s = torch.where(small, torch.ones_like(n2), n2)
    sin_t = 0.5 * torch.sqrt(n2s)
    cos_t = torch.clamp((torch.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.atan2(sin_t, cos_t)
    # small branch: theta ~= |w| / 2, so theta^2 / 12 ~= n2 / 48
    scale = torch.where(small, 0.5 + n2 / 48.0, theta / (2.0 * sin_t))
    return scale * w


def random_rotation(generator, dtype=torch.float32):
    """Uniform random rotation from a random unit quaternion, drawn from
    ``generator`` on the generator's device."""
    q = torch.randn(4, generator=generator, dtype=dtype,
                    device=generator.device)
    return quat_to_rot(q / torch.linalg.norm(q))
