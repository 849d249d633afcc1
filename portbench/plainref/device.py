"""Device, precision and kernel-backend policy of the port.

TF32 is Hopper's form of the TPU's bf16 matmul truncation (docs/PARITY.md,
"Numerical-exactness rules"): it keeps ~10 mantissa bits, enough to move a
nearest neighbour or a centroid. The port runs every float32 matmul and
convolution in full float32; importing this module sets that.

The entry points that place data (``Engine``, the importers, ``PointBatch``,
``convert.from_numpy``, ``multistart_rotations``) default to
``DEFAULT_DEVICE``, the card. There is no fallback: on a host without CUDA
the default raises, and a CPU run passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BACKENDS = ("auto", "cuda", "torch")
DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a host without one
    raises (never a quiet move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: no CUDA device on this host; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return dev


