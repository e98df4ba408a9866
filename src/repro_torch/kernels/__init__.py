"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package keeps the reference's three-part shape: ``csrc/*.cu`` (the
CUDA kernel, built by ``_build`` with nvcc for sm_90a and bound with
ctypes), ``ref.py`` (the plain PyTorch version) and ``ops.py`` (dispatch:
CPU tensors to the plain version, CUDA tensors to the kernel).

* ``expand``     — fused frontier expansion (adjacency gather + row gather
  + distance + first-occurrence tile dedup), every search-loop iteration.
* ``gatherdist`` — per-(query, id) row gather + distance: start points and
  the E=1 reference steps.
"""
from .expand import expand_frontier, expand_frontier_ref
from .gatherdist import gatherdist, gatherdist_ref

__all__ = ["expand_frontier", "expand_frontier_ref", "gatherdist",
           "gatherdist_ref"]
