"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package keeps the reference's three-part shape: ``csrc/*.cu`` (the
CUDA kernel, built by ``_build`` with nvcc for sm_90a and bound with
ctypes), ``ref.py`` (the plain PyTorch version) and ``ops.py`` (dispatch:
CPU tensors to the plain version, CUDA tensors to the kernel).

* ``expand``       — fused frontier expansion (adjacency gather + row gather
  + distance + first-occurrence tile dedup), every search-loop iteration;
  ``expand.cu`` over f32/bf16 rows, ``expand_int8.cu`` over an int8 corpus
  (certified lower bounds, f32-query or int8-query form).
* ``gatherdist``   — per-(query, id) row gather + distance: start points and
  the E=1 reference steps; ``gatherdist.cu`` and ``gatherdist_int8.cu``.
* ``rerank_fetch`` — exact f32 distances of flat (row id, query) pairs: the
  int8 corpus's guard-band rerank.
* ``rangescan``    — brute-force range scan (every distance, the exact
  in-range count, the K closest in-range points): the two-tower
  retrieval route; ``rangescan.cu`` (a 3xTF32 tensor-core scan fed by TMA
  after a query pre-pass, an f32 CUDA-core scan for rows TMA cannot
  address, and a merge kernel).
* ``flashattn``    — flash-attention forward (GQA, causal on absolute
  positions, sliding window, soft cap): the attention core of every LM
  layer at prefill and decode; ``flashattn.cu`` (a tile kernel and a
  decode kernel).
"""
from .expand import expand_frontier, expand_frontier_int8_ref, expand_frontier_ref
from .flashattn import flash_attention, flash_attention_ref
from .gatherdist import gatherdist, gatherdist_int8_ref, gatherdist_ref
from .rangescan import rangescan, rangescan_ref
from .rerank_fetch import fetch_rerank_dists, fetch_rerank_dists_ref, fetch_rerank_pairs

__all__ = ["expand_frontier", "expand_frontier_int8_ref", "expand_frontier_ref",
           "fetch_rerank_dists", "fetch_rerank_dists_ref", "fetch_rerank_pairs",
           "flash_attention", "flash_attention_ref",
           "gatherdist", "gatherdist_int8_ref", "gatherdist_ref", "rangescan",
           "rangescan_ref"]
