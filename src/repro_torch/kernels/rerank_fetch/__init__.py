from .ops import fetch_rerank_dists, fetch_rerank_pairs, rerank_fetch_cuda
from .ref import fetch_rerank_dists_ref, fetch_rerank_pairs_ref

__all__ = ["fetch_rerank_dists", "fetch_rerank_dists_ref", "fetch_rerank_pairs",
           "fetch_rerank_pairs_ref", "rerank_fetch_cuda"]
