"""Plain-PyTorch version of the fused frontier-expand kernel.

Semantics (shared with ``csrc/expand.cu``):

* frontier entries that are INVALID_ID or out of range yield all-INVALID
  rows (no distances, no n_dist contribution);
* every valid adjacency entry is counted in ``n_dist`` (duplicates
  included, before dedup);
* only the first occurrence of each neighbor id within a query's flattened
  E*R tile survives; later duplicates are INVALID / +inf;
* l2 is sum((x - q)^2) and ip is -x.q, in f32 whatever the storage dtype.
"""
from __future__ import annotations

import torch

from ...utils import INVALID_ID


def expand_frontier_ref(points, neighbors, frontier, queries, *,
                        metric: str = "l2"):
    """frontier (Q, E), queries (Q, d) ->
    (ids (Q, E*R) int32, dists (Q, E*R) f32, n_dist (Q,) int32)."""
    n = points.shape[0]
    qn, e = frontier.shape
    f_ok = (frontier >= 0) & (frontier < n)
    rows = neighbors[torch.where(f_ok, frontier, 0).long()]       # (Q, E, R)
    flat = torch.where(f_ok[..., None], rows, INVALID_ID).reshape(qn, -1)
    valid = (flat >= 0) & (flat < n)
    vecs = points[torch.where(valid, flat, 0).long()].float()     # (Q, T, d)
    qf = queries.float()
    if metric == "l2":
        diff = vecs - qf[:, None, :]
        d = torch.sum(diff * diff, dim=-1)
    else:
        d = -(vecs @ qf[:, :, None])[..., 0]
    t = torch.arange(flat.shape[1], device=flat.device)
    dup = torch.any((flat[:, :, None] == flat[:, None, :])
                    & (t[None, :] < t[:, None])[None]
                    & valid[:, None, :] & valid[:, :, None], dim=2)
    keep = valid & ~dup
    ids = torch.where(keep, flat, INVALID_ID).to(torch.int32)
    dists = torch.where(keep, d, torch.inf)
    return ids, dists, valid.sum(dim=1, dtype=torch.int32)


def expand_frontier_1(points, neighbors, frontier, q, metric: str = "l2"):
    """Single-query form: frontier (E,), q (d,) ->
    (ids (E*R,), dists (E*R,), n_dist ())."""
    ids, dists, nd = expand_frontier_ref(points, neighbors, frontier[None],
                                         q[None], metric=metric)
    return ids[0], dists[0], nd[0]
