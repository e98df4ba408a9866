from .ops import expand_cuda, expand_frontier, expand_int8_cuda
from .ref import expand_frontier_1, expand_frontier_int8_ref, expand_frontier_ref

__all__ = ["expand_cuda", "expand_frontier", "expand_frontier_1",
           "expand_frontier_int8_ref", "expand_frontier_ref",
           "expand_int8_cuda"]
