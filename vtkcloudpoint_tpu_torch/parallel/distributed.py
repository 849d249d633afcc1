"""Multi-process bring-up over torch.distributed (port of
vtkcloudpoint_tpu.parallel.distributed).

One process per device: every rank calls ``initialize`` (NCCL on the card,
gloo on the CPU), builds the mesh of every rank (``global_mesh``) and feeds
only its own blocks, which are already this rank's shard
(``make_global_blocks``); the sharded entry points of parallel.sharded
exchange what crosses shards through the mesh's collectives.

A single process needs no group at all (``initialize`` is then a no-op,
as in JAX), but the sharded entry points always take a mesh: a one-rank
run creates a one-rank group.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import socket

import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE
from .mesh import Mesh, make_mesh

INIT_TIMEOUT_S = 60.0


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=DEFAULT_DEVICE):
    """torch.distributed bring-up. A no-op returning False when
    single-process; arguments default from the environment variables
    COORDINATOR_ADDRESS ("host:port"), NUM_PROCESSES and PROCESS_ID.
    The backend is NCCL for a CUDA ``device``, gloo for the CPU; no
    fallback between them."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES",
                                                        "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", "0"))
    if num_processes <= 1:
        return False
    from ..utils.resilience import retry

    backend = _backend(device)

    def init_once():
        # a failed rendezvous can leave a half-built default group behind;
        # tear it down so the retry retries the connect, not a guaranteed
        # "already initialized" error
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id,
                timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
        except Exception:
            if dist.is_initialized():
                try:
                    dist.destroy_process_group()
                except Exception:
                    pass
            raise

    # ranks come up in any order at job start: retry with backoff instead
    # of failing the job on the first connect
    retry(attempts=5, backoff=2.0, exceptions=(RuntimeError, OSError))(
        init_once)()
    return True


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_group(device=DEFAULT_DEVICE):
    """A one-rank process group on a free 127.0.0.1 port -- NCCL for a
    CUDA device, gloo for the CPU -- yielding its mesh; destroyed on
    exit. For a single-process run of the sharded entry points."""
    dist.init_process_group(
        _backend(device), init_method=f"tcp://127.0.0.1:{free_port()}",
        world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        yield make_mesh(1, device=device)
    finally:
        dist.destroy_process_group()


def global_mesh(axis: str = "blocks", device=DEFAULT_DEVICE) -> Mesh:
    """Mesh over every rank of the world (1-D block axis)."""
    return make_mesh(None, axis, device)


def host_local_slice(n_global: int):
    """The [start, stop) range of a length-n_global block axis owned by this
    process (uniform split; the last process takes the remainder)."""
    p = dist.get_rank() if dist.is_initialized() else 0
    np_ = dist.get_world_size() if dist.is_initialized() else 1
    per = n_global // np_
    return p * per, (p + 1) * per if p < np_ - 1 else n_global


def make_global_blocks(local_blocks, mesh: Mesh, axis: str = "blocks"):
    """This rank's blocks on the mesh device. In JAX this assembles the
    process-local rows into a global sharded array; with one process per
    rank the local rows ARE this rank's shard."""
    from .mesh import replicated

    return replicated(mesh, local_blocks)
