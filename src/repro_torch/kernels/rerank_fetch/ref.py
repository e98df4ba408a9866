"""Plain-PyTorch version of the rerank-fetch kernel: gather + per-pair
exact distance, in the diff form (sum((x - q)^2) or -x.q)."""
from __future__ import annotations

import torch


def fetch_rerank_pairs_ref(raw, queries, ids, lanes, metric: str = "l2"):
    """(P,) exact f32 distances between raw[ids[p]] and queries[lanes[p]];
    ids are clipped to [0, N) and lanes to [0, Q)."""
    vecs = raw[torch.clamp(ids, 0, raw.shape[0] - 1).long()].float()
    qv = queries[torch.clamp(lanes, 0, queries.shape[0] - 1).long()].float()
    if metric == "l2":
        diff = vecs - qv
        return torch.sum(diff * diff, dim=-1)
    return -torch.sum(vecs * qv, dim=-1)


def fetch_rerank_dists_ref(raw, ids, qv, metric: str = "l2"):
    """The reference's signature: ``qv`` (P, d) holds each pair's query
    row, gathered by the caller."""
    lanes = torch.arange(qv.shape[0], dtype=torch.int32, device=qv.device)
    return fetch_rerank_pairs_ref(raw, qv, ids, lanes, metric)
