"""Device mesh over torch.distributed (port of
vtkcloudpoint_tpu.parallel.mesh).

JAX runs one shard_map program over a Mesh of devices; the port runs one
process per rank, each holding only its own shard. ``Mesh`` is one rank's
view of the 1-D mesh: its process group, its device and the collectives of
``jax.lax`` as methods (``axis_index``, ``psum``, ``pmin``, ``pmax``,
``all_gather``, ``all_to_all``, ``ppermute_ring``). On the card the group
is NCCL, one rank per GPU, and every collective runs on the card's
tensors; on the CPU it is gloo. A CUDA mesh over a gloo group, or a tensor
on another device than the mesh's, raises: no collective is ever staged
through the host.

NCCL has no bool reductions, so flags reduce as int32. At world size 1 the
ring hop is the identity; every other collective still goes through the
(one-rank) communicator.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE

# the output is the ranks' inputs concatenated along dim 0. torch 2.13
# deprecates all_gather_into_tensor (it warns on every call) for
# all_gather_single, which older torch (2.11) may lack.
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _local_device(device):
    """``device`` as a torch.device; "cuda" without an index is this
    rank's card, cuda:{LOCAL_RANK} (or the rank modulo the cards)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device on this host; pass device='cpu' "
                "(with a gloo process group) to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    return dev


class Mesh:
    """One rank's view of a 1-D device mesh (``axis`` names it, as in
    JAX). ``shape[axis]`` is the world size."""

    def __init__(self, group, axis: str, device):
        self.group = group
        self.axis = axis
        self.device = device
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.shape = {axis: self.size}

    # ---- placement ----
    def _check(self, x):
        if x.device != self.device:
            raise ValueError(
                f"collective on a tensor on {x.device}, mesh device "
                f"{self.device}: move it to the mesh device first")
        return x.contiguous()

    @staticmethod
    def _wire(x):
        """bool travels as uint8 (NCCL has no bool type)."""
        return x.to(torch.uint8) if x.dtype == torch.bool else x

    # ---- jax.lax collectives ----
    def axis_index(self) -> int:
        return self.rank

    def _reduce(self, x, op):
        x = self._check(x)
        out = x.to(torch.int32) if x.dtype == torch.bool else x.clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, x):
        """all_reduce(SUM); a bool sums as int32."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x):
        out = self._reduce(x, dist.ReduceOp.MIN)
        return out.bool() if x.dtype == torch.bool else out

    def pmax(self, x):
        out = self._reduce(x, dist.ReduceOp.MAX)
        return out.bool() if x.dtype == torch.bool else out

    def any(self, flag) -> bool:
        """A Python bool every rank reads alike: the all_reduce(MAX) of a
        local flag. Every loop whose trip count gates a collective ends on
        this, never on a local value."""
        t = torch.as_tensor(flag, device=self.device).reshape(()).to(
            torch.int32)
        return bool(self.pmax(t))

    def all_gather(self, x):
        """[size, *x.shape]: every rank's x in rank order."""
        x = self._check(x)
        w = self._wire(x).reshape((-1,) + tuple(x.shape[1:]))
        out = torch.empty((self.size * w.shape[0],) + tuple(w.shape[1:]),
                          dtype=w.dtype, device=self.device)
        _all_gather(out, w, group=self.group)
        return out.reshape((self.size,) + tuple(x.shape)).to(x.dtype)

    def all_to_all(self, x):
        """x [size, ...]: slot j goes to rank j; returns [size, ...] with
        slot i from rank i (jax.lax.all_to_all at split and concat axis
        0, fixed equal slots)."""
        x = self._check(x)
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all needs [{self.size}, ...] slots, "
                             f"got {tuple(x.shape)}")
        w = self._wire(x)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self.group)
        return out.to(x.dtype)

    def ppermute_ring(self, x):
        """One ring hop: send to rank (r + 1) % n, receive from
        (r - 1) % n (jax.lax.ppermute with perm i -> i + 1)."""
        x = self._check(x)
        if self.size == 1:
            return x
        w = self._wire(x)
        out = torch.empty_like(w)
        nxt = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        prv = dist.get_global_rank(self.group, (self.rank - 1) % self.size)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, w, nxt, self.group),
            dist.P2POp(dist.irecv, out, prv, self.group)])
        for r in reqs:
            r.wait()
        return out.to(x.dtype)


def make_mesh(n_devices: int | None = None, axis: str = "blocks",
              device=DEFAULT_DEVICE) -> Mesh:
    """The mesh of every rank of the world.

    Needs an initialised process group (parallel.distributed.initialize or
    torch.distributed.init_process_group). Raises when the world size is
    not ``n_devices``: a 1-rank "n-device" mesh never runs silently. The
    mesh lives on this rank's card unless ``device="cpu"``; a CUDA mesh
    needs the NCCL backend, a CPU mesh gloo.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call parallel.distributed."
            "initialize() or torch.distributed.init_process_group() on "
            "every rank first")
    group = dist.group.WORLD
    world = dist.get_world_size(group)
    n = n_devices or world
    if world != n:
        raise RuntimeError(
            f"make_mesh({n}) but the process group has {world} rank(s): "
            "start one process per device")
    dev = _local_device(device)
    backend = dist.get_backend(group)
    if dev.type == "cuda" and backend != "nccl":
        raise RuntimeError(
            f"make_mesh: a CUDA mesh needs the NCCL backend, got {backend!r}"
            " (collectives are never staged through the host)")
    if dev.type == "cpu" and backend != "gloo":
        raise RuntimeError(
            f"make_mesh: a CPU mesh needs the gloo backend, got {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group, axis, dev)


def _tensor(mesh: Mesh, arr):
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    return torch.as_tensor(arr).to(mesh.device)


def shard_blocks(mesh: Mesh, arr, axis: str = "blocks"):
    """This rank's slice of the leading (block) dimension of a global
    array, on the mesh device; the length must divide by the mesh size."""
    n = mesh.shape[axis]
    if arr.shape[0] % n:
        raise ValueError(f"leading dimension {arr.shape[0]} does not "
                         f"divide by the mesh size {n}")
    per = arr.shape[0] // n
    return _tensor(mesh, arr[mesh.rank * per:(mesh.rank + 1) * per])


def replicated(mesh: Mesh, arr):
    """The whole array on this rank's device."""
    return _tensor(mesh, arr)


def gather_blocks(mesh: Mesh, local):
    """Every rank's local shard concatenated in rank order along the
    leading dimension: the global layout shard_blocks cut."""
    g = mesh.all_gather(local)
    return g.reshape((-1,) + tuple(local.shape[1:]))
