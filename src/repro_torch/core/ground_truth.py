"""Exact (brute-force) range search and top-k — the oracle for everything.

Blocked over the database so memory stays bounded; each block's distances
are one f32 matmul plus norms (``pairwise_dist``), which is what the
reference leaves to XLA.
"""
from __future__ import annotations

import torch

from ..utils import INVALID_ID, resolve_device
from .beam_search import _f32_ascending_key
from .distances import pairwise_dist


def _on(device, *xs):
    dev = resolve_device(device)
    return [torch.as_tensor(x, device=dev).float() for x in xs]


def _dist_id_key(dists: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 key ordering (distance, id) lexicographically (total order)."""
    return ((_f32_ascending_key(dists) - 0x80000000) << 32) | ids.to(torch.int64)


def exact_range_search(points, queries, r, metric: str = "l2",
                       cap: int = 4096, block: int = 8192,
                       device="cuda"):
    """Returns (ids (Q, cap), dists (Q, cap), counts (Q,)).

    ``r`` is a scalar radius or a ``(Q,)`` vector. ``counts`` is exact even
    when it exceeds ``cap``; ids/dists keep the ``cap`` closest in-range
    points, ascending by (distance, id)."""
    points, queries = _on(device, points, queries)
    n = points.shape[0]
    qn = queries.shape[0]
    dev = points.device
    rb = torch.as_tensor(r, dtype=torch.float32, device=dev)
    rb = rb[:, None] if rb.dim() == 1 else rb
    counts = torch.zeros(qn, dtype=torch.int32, device=dev)
    lanes, hit_ids, hit_d = [], [], []
    for start in range(0, n, block):
        bd = pairwise_dist(queries, points[start:start + block], metric)
        ok = bd <= rb
        counts += torch.sum(ok, dim=1, dtype=torch.int32)
        qi, j = torch.nonzero(ok, as_tuple=True)
        lanes.append(qi)
        hit_ids.append(j + start)
        hit_d.append(bd[qi, j])
    lane = torch.cat(lanes)
    hid = torch.cat(hit_ids)
    hd = torch.cat(hit_d)
    # order by (lane, distance, id), then rank within each lane
    order = torch.sort(_dist_id_key(hd, hid), stable=True).indices
    order = order[torch.sort(lane[order], stable=True).indices]
    lane, hid, hd = lane[order], hid[order], hd[order]
    first = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    rank = torch.arange(lane.shape[0], device=dev) - first[lane]
    keep = rank < cap
    ids = torch.full((qn, cap), INVALID_ID, dtype=torch.int32, device=dev)
    dists = torch.full((qn, cap), torch.inf, device=dev)
    ids[lane[keep], rank[keep]] = hid[keep].to(torch.int32)
    dists[lane[keep], rank[keep]] = hd[keep]
    return ids, dists, counts


def exact_topk(points, queries, k: int = 10, metric: str = "l2",
               block: int = 8192, query_block: int = 8192, device="cuda"):
    """Exact k nearest neighbors: (ids (Q, k), dists (Q, k)), ascending by
    (distance, id). Within a block, ``torch.topk`` may pick either of two
    points whose distances are equal in f32 at the k-th place; the
    reference then keeps the lower id."""
    points, queries = _on(device, points, queries)
    n = points.shape[0]
    out_ids, out_d = [], []
    for q0 in range(0, queries.shape[0], query_block):
        qb = queries[q0:q0 + query_block]
        ids = torch.full((qb.shape[0], 0), INVALID_ID, dtype=torch.int64,
                         device=points.device)
        dists = torch.empty((qb.shape[0], 0), device=points.device)
        for start in range(0, n, block):
            bd = pairwise_dist(qb, points[start:start + block], metric)
            kb = min(k, bd.shape[1])
            bv, bi = torch.topk(bd, kb, dim=1, largest=False)
            cd = torch.cat([dists, bv], 1)
            ci = torch.cat([ids, bi + start], 1)
            sel = torch.sort(_dist_id_key(cd, ci), dim=1).indices[:, :k]
            dists, ids = torch.gather(cd, 1, sel), torch.gather(ci, 1, sel)
        if ids.shape[1] < k:  # fewer than k points: pad like the reference
            pad = k - ids.shape[1]
            ids = torch.nn.functional.pad(ids, (0, pad), value=INVALID_ID)
            dists = torch.nn.functional.pad(dists, (0, pad), value=float("inf"))
        out_ids.append(ids.to(torch.int32))
        out_d.append(dists)
    return torch.cat(out_ids), torch.cat(out_d)


def range_counts_at(points, queries, radii, metric: str = "l2",
                    block: int = 2048, device="cuda") -> torch.Tensor:
    """(Q, G) exact match counts at each radius (Sec. 3 capture curves)."""
    points, queries, radii = _on(device, points, queries, radii)
    counts = torch.zeros((queries.shape[0], radii.shape[0]), dtype=torch.int32,
                         device=points.device)
    for start in range(0, points.shape[0], block):
        bd = pairwise_dist(queries, points[start:start + block], metric)
        counts += torch.sum(bd[:, :, None] <= radii[None, None, :], dim=1,
                            dtype=torch.int32)
    return counts

