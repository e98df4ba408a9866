"""Graph construction. This slice has the brute-force k-NN graph only; the
Vamana build (``robust_prune``, ``build_vamana``) is ROADMAP.md §1 item 6."""
from __future__ import annotations

import torch

from .graph import Graph
from .ground_truth import exact_topk


def build_knn_graph(points, k: int = 16, metric: str = "l2",
                    device="cuda", block: int = 16384,
                    query_block: int = 8192) -> Graph:
    """Brute-force k-NN graph: each node's k nearest other nodes."""
    ids, _ = exact_topk(points, points, k=k + 1, metric=metric, block=block,
                        query_block=query_block, device=device)
    # drop the self column: move self (if present) to the end, take k
    row = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)[:, None]
    col = torch.arange(k + 1, device=ids.device)[None, :]
    sort_key = torch.where(ids != row, col, k + 1)
    order = torch.argsort(sort_key, dim=1, stable=True)
    return Graph(neighbors=torch.gather(ids, 1, order)[:, :k].contiguous())
