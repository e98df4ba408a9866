from .ops import expand_cuda, expand_frontier
from .ref import expand_frontier_1, expand_frontier_ref

__all__ = ["expand_cuda", "expand_frontier", "expand_frontier_1",
           "expand_frontier_ref"]
