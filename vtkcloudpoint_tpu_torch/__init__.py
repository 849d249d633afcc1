"""PyTorch/CUDA port of vtkcloudpoint_tpu.

Mirrors the JAX package module for module: ``vtkcloudpoint_tpu_torch.X.f`` is
the counterpart of ``vtkcloudpoint_tpu.X.f``. Hand-written Hopper kernels live
under ``kernels/`` (CUDA sources in ``kernels/csrc/``); every kernel has a
plain PyTorch version beside it, which serves CPU tensors and the parity tests.
The package imports torch and never jax.
"""
