"""Distance functions for the range-retrieval engine.

* ``"l2"`` — squared Euclidean distance (monotone in true L2; the radii of
  the big-ann-benchmarks range track are squared-L2 values).
* ``"ip"`` — negative inner product; radii may be negative.
"""
from __future__ import annotations

import torch

from ..kernels.gatherdist import gatherdist

METRICS = ("l2", "ip")


def _check(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")


def point_dist(x: torch.Tensor, q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Distance between broadcastable point arrays along the last axis."""
    _check(metric)
    if metric == "l2":
        d = x - q
        return torch.sum(d * d, dim=-1)
    return -torch.sum(x * q, dim=-1)


def pairwise_dist(queries: torch.Tensor, points: torch.Tensor,
                  metric: str = "l2") -> torch.Tensor:
    """(Q, d) x (N, d) -> (Q, N) distance matrix via a single matmul, in
    full f32 (TF32 is switched off: it keeps ~3 decimal digits, which would
    move the oracle's radius decisions)."""
    _check(metric)
    torch.backends.cuda.matmul.allow_tf32 = False
    dots = queries @ points.T
    if metric == "ip":
        return -dots
    qn = torch.sum(queries * queries, dim=-1, keepdim=True)
    pn = torch.sum(points * points, dim=-1, keepdim=True)
    return torch.clamp(qn + pn.T - 2.0 * dots, min=0.0)


def gather_dist(points, ids: torch.Tensor, q: torch.Tensor,
                metric: str = "l2", use_kernel: bool = True) -> torch.Tensor:
    """(Q, S) distances from q[i] to points[ids[i, j]]; padded/invalid ids
    get +inf. Math in f32 whatever the storage dtype. A ``QuantizedCorpus``
    gives each candidate's certified lower bound in the f32-query form
    (``core.corpus.quantized_gather_lb``), as the reference's does. On a
    CUDA corpus this is the gatherdist (or gatherdist-int8) kernel."""
    _check(metric)
    return gatherdist(points, ids.to(torch.int32).contiguous(),
                      q.float().contiguous(), metric=metric,
                      use_kernel=use_kernel)
