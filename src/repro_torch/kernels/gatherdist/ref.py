"""Plain-PyTorch version of the gatherdist kernel."""
from __future__ import annotations

import torch


def gatherdist_ref(points, ids, queries, *, metric: str = "l2"):
    """(Q, S) distances from queries[i] to points[ids[i, j]] in f32;
    INVALID or out-of-range ids give +inf."""
    n = points.shape[0]
    valid = (ids >= 0) & (ids < n)
    vecs = points[torch.where(valid, ids, 0).long()].float()      # (Q, S, d)
    q = queries.float()[:, None, :]
    if metric == "l2":
        diff = vecs - q
        d = torch.sum(diff * diff, dim=-1)
    else:
        d = -torch.sum(vecs * q, dim=-1)
    return torch.where(valid, d, torch.inf)
