"""Plain-PyTorch versions of the fused frontier-expand kernels.

Semantics (shared with ``csrc/expand.cu`` and ``csrc/expand_int8.cu``):

* frontier entries that are INVALID_ID or out of range yield all-INVALID
  rows (no distances, no n_dist contribution);
* every valid adjacency entry is counted in ``n_dist`` (duplicates
  included, before dedup);
* only the first occurrence of each neighbor id within a query's flattened
  E*R tile survives; later duplicates are INVALID / +inf;
* l2 is sum((x - q)^2) and ip is -x.q, in f32 whatever the storage dtype;
* over an int8 ``QuantizedCorpus`` (duck-typed on ``.codes``) the distance
  is the candidate's certified lower bound (``core/corpus.py``), in the
  f32-query form or, with ``quantize_query``, the int8-query form.
"""
from __future__ import annotations

import torch

from ...utils import INVALID_ID


def _tile(n: int, neighbors, frontier):
    """(flat ids (Q, E*R), valid, first occurrences) of the frontier's
    adjacency rows."""
    qn = frontier.shape[0]
    f_ok = (frontier >= 0) & (frontier < n)
    rows = neighbors[torch.where(f_ok, frontier, 0).long()]       # (Q, E, R)
    flat = torch.where(f_ok[..., None], rows, INVALID_ID).reshape(qn, -1)
    valid = (flat >= 0) & (flat < n)
    t = torch.arange(flat.shape[1], device=flat.device)
    dup = torch.any((flat[:, :, None] == flat[:, None, :])
                    & (t[None, :] < t[:, None])[None]
                    & valid[:, None, :] & valid[:, :, None], dim=2)
    return flat, valid, valid & ~dup


def _outputs(flat, valid, keep, d):
    ids = torch.where(keep, flat, INVALID_ID).to(torch.int32)
    dists = torch.where(keep, d, torch.inf)
    return ids, dists, valid.sum(dim=1, dtype=torch.int32)


def expand_frontier_ref(points, neighbors, frontier, queries, *,
                        metric: str = "l2"):
    """frontier (Q, E), queries (Q, d) ->
    (ids (Q, E*R) int32, dists (Q, E*R) f32, n_dist (Q,) int32).
    A ``QuantizedCorpus`` takes the f32-query form, as the reference's
    plain version does."""
    if getattr(points, "codes", None) is not None:
        return expand_frontier_int8_ref(points, neighbors, frontier, queries,
                                        metric=metric)
    flat, valid, keep = _tile(points.shape[0], neighbors, frontier)
    vecs = points[torch.where(valid, flat, 0).long()].float()     # (Q, T, d)
    qf = queries.float()
    if metric == "l2":
        diff = vecs - qf[:, None, :]
        d = torch.sum(diff * diff, dim=-1)
    else:
        d = -(vecs @ qf[:, :, None])[..., 0]
    return _outputs(flat, valid, keep, d)


def expand_frontier_int8_ref(qc, neighbors, frontier, queries, *,
                             metric: str = "l2", quantize_query: bool = False,
                             return_dots: bool = False):
    """The int8 kernel's function over a ``QuantizedCorpus``: the f32-query
    form (``quantized_gather_lb``, the reference's XLA path) or, with
    ``quantize_query``, the int8-query form (``quantized_query_lb``, the
    Pallas kernel's arithmetic). ``return_dots`` appends the int32 dots of
    the int8-query form (0 on INVALID slots)."""
    from ...core.corpus import quantized_gather_lb, quantized_query_lb
    flat, valid, keep = _tile(qc.shape[0], neighbors, frontier)
    safe = torch.where(valid, flat, 0)
    if quantize_query:
        d, idot = quantized_query_lb(qc, safe, queries, metric)
    else:
        if return_dots:
            raise ValueError("the f32-query form takes no int8 dot")
        d = quantized_gather_lb(qc, safe, queries, metric)
    out = _outputs(flat, valid, keep, d)
    if return_dots:
        return (*out, torch.where(keep, idot, 0))
    return out


def expand_frontier_1(points, neighbors, frontier, q, metric: str = "l2"):
    """Single-query form: frontier (E,), q (d,) ->
    (ids (E*R,), dists (E*R,), n_dist ())."""
    ids, dists, nd = expand_frontier_ref(points, neighbors, frontier[None],
                                         q[None], metric=metric)
    return ids[0], dists[0], nd[0]
