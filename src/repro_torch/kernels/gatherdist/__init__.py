from .ops import gatherdist, gatherdist_cuda, gatherdist_int8_cuda
from .ref import gatherdist_int8_ref, gatherdist_ref

__all__ = ["gatherdist", "gatherdist_cuda", "gatherdist_int8_cuda",
           "gatherdist_int8_ref", "gatherdist_ref"]
