from .ops import gatherdist, gatherdist_cuda
from .ref import gatherdist_ref

__all__ = ["gatherdist", "gatherdist_cuda", "gatherdist_ref"]
