"""The ICP step, hand-written for Hopper.

K5, one ICP iteration after the correspondence search (csrc/icp_step.cu):
float64 moments of the valid sources, Horn's solve, the pose update and
the convergence test of ``register/icp.py``'s loop, in one launch on a
state that lives on the card. It replaces no Pallas kernel: the JAX
package runs this body inside a jitted ``lax.while_loop``, and the port's
eager loop was host-bound (PERF.md §5).

The state (``StepState``): ``pose`` f32 [13] (R row-major, t, and d, the
last iteration's summed squared distance, +inf at the start), ``flags``
i32 [4] (iterations, converged, done, and the kernel's block ticket) and
``p`` f32 [N, 3], the moved sources that the next correspondence search
reads. ``icp_step_plain`` is the same state transition in PyTorch (float64
moments, ``torch.linalg.eigh`` in float64); ``icp_step_cuda`` launches the
kernel and counts ``step_launches``. A step taken once done is set changes
nothing, so iterations launched past the end are no-ops.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import se3
from ..utils import profiling as prof
from . import build

SOURCE = "vtkcloudpoint_tpu_torch/kernels/csrc/icp_step.cu"
REPLACES = None          # no Pallas kernel: a jitted lax.while_loop's body

ITERATIONS, CONVERGED, DONE = 0, 1, 2
# ICP iterations of one call (PERF.md §5): a stream scan's ICP takes 2.875
# on average, so a first chunk of 4 ends most of them at one read of the
# card; a SLAM ICP takes ~21 (6,585 in ~310 calls, tol 1e-10), so chunks
# of 8 after it end those at three or four reads and waste at most 7
# launches.
FIRST_CHUNK = 4
CHUNK = 8

step_launches = 0


class StepState(NamedTuple):
    pose: torch.Tensor       # f32 [13]: R row-major (9), t (3), d
    flags: torch.Tensor      # i32 [4]: iterations, converged, done, ticket
    p: torch.Tensor          # f32 [N, 3]: R source + t


def chunk_schedule(max_iterations: int) -> list:
    """Iterations launched between two reads of the card: FIRST_CHUNK,
    then CHUNK at a time, each capped by the iterations left."""
    out, left, size = [], max_iterations, FIRST_CHUNK
    while left > 0:
        out.append(min(size, left))
        left -= out[-1]
        size = CHUNK
    return out


def init_state(r, t, source) -> StepState:
    """The state before the first iteration, from the start pose (R, t),
    made on source's device with no read of it on the host."""
    dev = source.device
    inf = torch.full((1,), math.inf, dtype=torch.float32, device=dev)
    pose = torch.cat([r.reshape(9).to(torch.float32),
                      t.reshape(3).to(torch.float32), inf])
    flags = torch.zeros(4, dtype=torch.int32, device=dev)
    return StepState(pose, flags, se3.apply_rigid(r, t, source).contiguous())


def moved(pose, source):
    """R source + t in float32, as the kernel rounds it: ((R_a0 x + R_a1 y)
    + R_a2 z) + t_a, with no multiply-add contracted."""
    r, t = pose[:9].view(3, 3), pose[9:12]
    return ((source[:, 0:1] * r[:, 0] + source[:, 1:2] * r[:, 1])
            + source[:, 2:3] * r[:, 2]) + t


def icp_step_plain(state: StepState, idx, d2, source, source_valid, target,
                   tol: float, max_iterations: int) -> None:
    """One ICP iteration on ``state``, in place, given the correspondences
    (idx, d2) of ``state.p``: the kernel's transition in PyTorch."""
    if prof.sync(bool, state.flags[DONE] != 0):
        return
    w = source_valid[:, None]
    p = torch.where(w, state.p.to(torch.float64), 0.0)
    y = torch.where(w, target[idx.long()].to(torch.float64), 0.0)
    r1, t1 = se3.horn_from_moments(source_valid.to(torch.float64).sum(),
                                   p.sum(dim=0), y.sum(dim=0), p.T @ y)
    r = state.pose[:9].view(3, 3).to(torch.float64)
    t = state.pose[9:12].to(torch.float64)
    d = torch.where(source_valid, d2.to(torch.float64), 0.0).sum().to(
        torch.float32)
    converged = torch.abs(d - state.pose[12]) < tol
    it = state.flags[ITERATIONS] + 1
    done = converged | (it >= max_iterations)
    state.pose[:9] = (r1 @ r).reshape(9)
    state.pose[9:12] = r1 @ t + t1
    state.pose[12] = d
    state.flags[ITERATIONS] = it
    state.flags[CONVERGED] = converged
    state.flags[DONE] = done
    if not prof.sync(bool, done):
        state.p.copy_(moved(state.pose, source))


def icp_step_cuda(state: StepState, idx, d2, source, source_valid, target,
                  tol: float, max_iterations: int) -> None:
    """Launch K5 on CUDA tensors: one ICP iteration on ``state``, in place,
    given K3's (idx i32 [N], d2 f32 [N]) for ``state.p``. Launches on the
    current stream and does not synchronise."""
    global step_launches
    build.require_cuda("icp_step_cuda", source=source,
                       source_valid=source_valid, target=target, idx=idx,
                       d2=d2, pose=state.pose, flags=state.flags, p=state.p)
    n, m = source.shape[0], target.shape[0]
    if (source.dtype != torch.float32 or target.dtype != torch.float32
            or state.p.dtype != torch.float32 or d2.dtype != torch.float32
            or state.pose.dtype != torch.float32
            or idx.dtype != torch.int32 or state.flags.dtype != torch.int32
            or source_valid.dtype != torch.bool):
        raise ValueError("icp_step_cuda: source, target, p, d2 and pose "
                         "must be float32, idx and flags int32, "
                         "source_valid bool")
    if (tuple(source.shape) != (n, 3) or tuple(target.shape) != (m, 3)
            or tuple(state.p.shape) != (n, 3)
            or tuple(source_valid.shape) != (n,)
            or tuple(idx.shape) != (n,) or tuple(d2.shape) != (n,)
            or tuple(state.pose.shape) != (13,)
            or tuple(state.flags.shape) != (4,)):
        raise ValueError("icp_step_cuda: shapes must be source and p "
                         "[N, 3], target [M, 3], source_valid, idx and d2 "
                         "[N], pose [13], flags [4]")
    if n > 0 and m == 0:
        raise ValueError("icp_step_cuda: no target row to correspond to")
    if n >= 2**30:
        raise ValueError("icp_step_cuda: N must be below 2^30")
    lib = build.load()
    partials = torch.empty(lib.vtkcp_icp_partials(n), dtype=torch.float64,
                           device=source.device)
    with torch.cuda.device(source.device):
        err = lib.vtkcp_icp_step(
            source.data_ptr(), source_valid.data_ptr(), target.data_ptr(),
            idx.data_ptr(), d2.data_ptr(), n, tol, max_iterations,
            state.p.data_ptr(), state.pose.data_ptr(),
            state.flags.data_ptr(), partials.data_ptr(),
            build.stream_handle(source.device))
    build.check(err, "vtkcp_icp_step")
    step_launches += 1
