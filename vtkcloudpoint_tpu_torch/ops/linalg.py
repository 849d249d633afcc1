"""Small dense linear algebra: the reference Matrix.cs role (SURVEY.md C17),
port of vtkcloudpoint_tpu.ops.linalg.

- jacobi_eigh: a cyclic-Jacobi symmetric eigensolver with a fixed number of
  sweeps over the off-diagonal pairs in the JAX package's order -- the
  semantic stand-in for the reference's ComputeEvJacobi (whose index bugs,
  Matrix.cs:636-657, are not reproduced);
- solve / inv / det: aliases of torch.linalg (Matrix.cs:99-179), as the
  JAX module aliases jnp.linalg.
"""
from __future__ import annotations

import torch

from .. import device as _device  # noqa: F401  (full-f32 matmuls)

solve = torch.linalg.solve      # Matrix.SolveWith (Matrix.cs:99-112)
inv = torch.linalg.inv          # Matrix.Invert (Matrix.cs:156-170)
det = torch.linalg.det          # Matrix.Det (Matrix.cs:173-179)


def jacobi_eigh(a, sweeps: int = 10):
    """Cyclic Jacobi eigensolve for a symmetric [n, n] matrix.

    Returns (eigenvalues [n] ascending, eigenvectors [n, n] columns). Each
    sweep rotates every off-diagonal pair (p, q), p < q in row order, once.
    """
    n = a.shape[0]
    pairs = [(p, q) for p in range(n - 1) for q in range(p + 1, n)]
    m = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device)
    for _ in range(sweeps):
        for p, q in pairs:
            # rotation angle: theta = 0.5 atan2(2 apq, app - aqq)
            theta = 0.5 * torch.atan2(2.0 * m[p, q], m[p, p] - m[q, q])
            c, s = torch.cos(theta), torch.sin(theta)
            # G^T M G applied via row, then column updates
            rp, rq = m[p, :].clone(), m[q, :].clone()
            m[p, :] = c * rp + s * rq
            m[q, :] = -s * rp + c * rq
            cp, cq = m[:, p].clone(), m[:, q].clone()
            m[:, p] = c * cp + s * cq
            m[:, q] = -s * cp + c * cq
            vp, vq = v[:, p].clone(), v[:, q].clone()
            v[:, p] = c * vp + s * vq
            v[:, q] = -s * vp + c * vq
    w = torch.diagonal(m)
    order = torch.argsort(w, stable=True)
    return w[order], v[:, order]
