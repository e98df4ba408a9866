"""RangeSearchEngine — one graph index answering top-k and range queries."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils import resolve_device
from .beam_search import SearchConfig, beam_search_batch, broadcast_radius, topk_from_state
from .corpus import (
    Corpus,
    bytes_per_vector,
    corpus_cast,
    corpus_dim,
    corpus_dtype_name,
    corpus_size,
)
from .graph import Graph, start_points
from .range_search import (
    RangeConfig,
    RangeResult,
    range_search_compacted,
    range_search_fused,
)

@dataclasses.dataclass
class RangeSearchEngine:
    """An in-memory graph index over a corpus on one device: an (N, d) f32
    or bf16 tensor, or an int8 ``QuantizedCorpus`` (codes + metadata + the
    raw f32 rows its rerank reads). Every query runs on the engine's
    device."""

    points: Corpus          # (N, d) float32 / bfloat16, or QuantizedCorpus
    graph: Graph
    start_ids: torch.Tensor # (S,) int32 search entry points
    metric: str = "l2"

    @property
    def device(self) -> torch.device:
        return self.points.device

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_graph(points, graph: Graph, metric: str = "l2",
                   n_starts: int = 4, corpus_dtype: Optional[str] = None,
                   device="cuda") -> "RangeSearchEngine":
        """Engine over ``points`` (numpy or tensor) and a built ``graph``.
        Entry points are chosen on the f32 vectors; ``corpus_dtype``
        ("float32" | "bfloat16" | "int8") sets what the search stores and
        gathers. "int8" quantizes on the engine's device and keeps the raw
        f32 rows for the guard-band rerank. The reference's ``labels``,
        ``tier`` and ``resident_mb`` (filtered and tiered corpora) are later
        slices of the port (ROADMAP.md §1)."""
        dev = resolve_device(device)
        pts = torch.as_tensor(points, device=dev).float().contiguous()
        starts = start_points(pts, metric, n_starts)
        if corpus_dtype is not None:
            pts = corpus_cast(pts, corpus_dtype)
        nbrs = graph.neighbors.to(device=dev, dtype=torch.int32).contiguous()
        return RangeSearchEngine(points=pts, graph=Graph(neighbors=nbrs),
                                 start_ids=starts, metric=metric)

    # -- queries -------------------------------------------------------------
    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries).to(device=self.device,
                                           dtype=torch.float32).contiguous()

    def topk(self, queries, k: int = 10, cfg: Optional[SearchConfig] = None):
        cfg = cfg or SearchConfig(beam=max(2 * k, 32), max_beam=max(2 * k, 32),
                                  visit_cap=max(4 * k, 128), metric=self.metric)
        st = beam_search_batch(self.points, self.graph, self._queries(queries),
                               self.start_ids, float("inf"), cfg)
        return topk_from_state(st, k)

    def range(self, queries, r, *, cfg: Optional[RangeConfig] = None,
              es_radius=None, compacted: bool = True, tombstones=None,
              filter=None) -> RangeResult:
        """Range search. ``r`` (and ``es_radius``) is a scalar applied to
        every query or a ``(Q,)`` vector of per-query radii. ``tombstones``
        is a packed dead-slot bitset: deleted slots still route the
        traversal but never appear in results. ``filter`` (label predicates)
        is a later slice and raises."""
        cfg = cfg or RangeConfig(search=SearchConfig(metric=self.metric))
        if cfg.search.metric != self.metric:
            cfg = dataclasses.replace(cfg, search=dataclasses.replace(
                cfg.search, metric=self.metric))
        q = self._queries(queries)
        n = q.shape[0]
        r = broadcast_radius(r, n, device=self.device)
        if es_radius is not None:
            es_radius = broadcast_radius(es_radius, n, device=self.device)
        fn = range_search_compacted if compacted else range_search_fused
        return fn(corpus=self.points, graph=self.graph, queries=q,
                  start_ids=self.start_ids, r=r, cfg=cfg,
                  es_radius=es_radius, tombstones=tombstones,
                  label_filter=filter)

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        deg = self.graph.degrees().float()
        return dict(
            num_points=corpus_size(self.points),
            dim=corpus_dim(self.points),
            max_degree=int(self.graph.max_degree),
            mean_degree=float(deg.mean()),
            min_degree=int(deg.min()),
            metric=self.metric,
            corpus_dtype=corpus_dtype_name(self.points),
            hot_bytes_per_vector=bytes_per_vector(self.points),
        )
