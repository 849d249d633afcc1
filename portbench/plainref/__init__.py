"""The benchmark's plain reference: a frozen copy of the plain PyTorch
paths of ``vtkcloudpoint_tpu_torch`` (the versions that serve CPU tensors),
taken when the benchmark was defined and kept here so that a later change to
the program cannot move the yardstick.

Module for module it mirrors the package it was copied from, and holds only
what ``chains.py``, the three jobs end to end, reaches: the dispatch to the
hand-written kernels (every call runs the plain version), the sharded and
checkpointed paths, the folder import, the exporters and every function no
job calls were cut (portbench/tests keeps it so). It imports torch and numpy
only: never the program, never JAX.
"""
