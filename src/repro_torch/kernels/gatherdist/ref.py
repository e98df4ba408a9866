"""Plain-PyTorch versions of the gatherdist kernels."""
from __future__ import annotations

import torch


def gatherdist_ref(points, ids, queries, *, metric: str = "l2"):
    """(Q, S) distances from queries[i] to points[ids[i, j]] in f32;
    INVALID or out-of-range ids give +inf. A ``QuantizedCorpus`` (duck-typed
    on ``.codes``) gives certified lower bounds in the f32-query form."""
    if getattr(points, "codes", None) is not None:
        return gatherdist_int8_ref(points, ids, queries, metric=metric)
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


def gatherdist_int8_ref(qc, ids, queries, *, metric: str = "l2",
                        quantize_query: bool = False,
                        return_dots: bool = False):
    """The int8 kernel's function over a ``QuantizedCorpus``: (Q, S)
    certified lower bounds in the f32-query form or, with
    ``quantize_query``, the int8-query form; INVALID or out-of-range ids
    give +inf. ``return_dots`` also returns the int8-query form's int32
    dots (0 on invalid pairs)."""
    from ...core.corpus import quantized_gather_lb, quantized_query_lb
    n = qc.shape[0]
    valid = (ids >= 0) & (ids < n)
    safe = torch.where(valid, ids, 0)
    if quantize_query:
        d, idot = quantized_query_lb(qc, safe, queries, metric)
    else:
        if return_dots:
            raise ValueError("the f32-query form takes no int8 dot")
        d = quantized_gather_lb(qc, safe, queries, metric)
    out = torch.where(valid, d, torch.inf)
    if return_dots:
        return out, torch.where(valid, idot, 0)
    return out
