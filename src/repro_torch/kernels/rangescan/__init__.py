from .ops import rangescan, rangescan_cuda
from .ref import rangescan_dists, rangescan_ref

__all__ = ["rangescan", "rangescan_cuda", "rangescan_dists", "rangescan_ref"]
