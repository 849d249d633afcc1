"""Build and load the hand-written Hopper kernels.

All CUDA sources under ``csrc/`` compile with nvcc into ONE shared library
with a plain C interface, loaded with ctypes (seconds to build; a source that
includes PyTorch's headers takes minutes). Each source compiles to an object
in its own nvcc process, all started together, and one more nvcc links
them. The library is built at first use into ``build/kernels/`` at the
repository root, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once. Nothing here runs at
import time.

Flags: ``sm_90a`` (Hopper); ``--fmad=false`` because a contracted a*b+c
changes the float decisions the kernels share with their plain versions
(d <= eps, d2 <= r2, argmins); no ``--use_fast_math`` because those
decisions need IEEE division, sqrt and isinf/isnan.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("dbscan_block.cu", "shapes.cu", "nn.cu", "radius.cu",
           "icp_step.cu")
# headers the sources include (found beside them); part of the build's key
HEADERS = ("bits.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
              "--ptxas-options=-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every function returns its cudaError_t as int
SIGNATURES = {
    "vtkcp_dbscan_blocks": (_P, _P, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P),
    "vtkcp_dbscan_smem_bytes": (_I, _I, _I),
    "vtkcp_cluster_shapes": (_P, _P, _I, _I, _I, _P, _P),
    "vtkcp_shapes_smem_bytes": (_I, _I),
    "vtkcp_shapes_group": (_I, _I, _I),
    "vtkcp_nn_argmin": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "vtkcp_nn_queries_per_block": (),
    "vtkcp_radius_count": (_P, _P, _I, _I, _I, _F, _P, _P),
    "vtkcp_icp_partials": (_I,),
    "vtkcp_icp_step": (_P, _P, _P, _P, _P, _I, _F, _I, _P, _P, _P, _P, _P),
}

_lib = None
build_info = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _digest(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags + LINK_FLAGS).encode())
    for name in tuple(sources) + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path(sources=SOURCES, defines=(),
                 stem: str = "libvtkcp_kernels") -> Path:
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    return BUILD_DIR / f"{stem}_{_digest(sources, flags)}.so"


def build(sources=SOURCES, defines=(),
          stem: str = "libvtkcp_kernels") -> Path:
    """Compile ``sources`` (default: every kernel) with the macros
    ``defines`` into one library, unless a build of these exact sources and
    flags exists. The kernel library has no macro; a diagnostic build
    (tools/profile_k1.py) names its own. Records the build's seconds and
    nvcc's -Xptxas=-v report in ``build_info``."""
    path = library_path(sources, defines, stem)
    if path.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj),
                               str(CSRC / src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    report = "".join(logs)
    for src, p, log in zip(sources, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} ({p.returncode}):\n"
                               f"{log}")
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)            # atomic: no reader sees a partial .so
    path.with_suffix(".log").write_text(report)
    build_info.update(seconds=seconds, cached=False, ptxas=report)
    return path


def open_library(path, signatures=SIGNATURES) -> ctypes.CDLL:
    """Load a built library with ctypes and declare ``signatures`` (the
    functions it exports, each returning its cudaError_t as int)."""
    lib = ctypes.CDLL(str(path))
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.vtkcp_error_string.argtypes = [ctypes.c_int]
    lib.vtkcp_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = open_library(build())
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        msg = load().vtkcp_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require_cuda(name: str, **tensors) -> None:
    """Every tensor on one CUDA device and contiguous, else raise."""
    devices = {t.device for t in tensors.values()}
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
