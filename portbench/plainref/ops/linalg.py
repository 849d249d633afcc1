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


