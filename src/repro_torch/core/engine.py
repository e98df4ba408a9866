"""RangeSearchEngine — one graph index answering top-k and range queries."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import trace
from ..utils import resolve_device
from .beam_search import SearchConfig, beam_search_batch, broadcast_radius, topk_from_state
from .build import BuildConfig, build_vamana
from .corpus import (
    Corpus,
    bytes_per_vector,
    corpus_cast,
    corpus_dim,
    corpus_dtype_name,
    corpus_size,
    hot_arm,
)
from .graph import Graph, start_points
from .labels import as_label_rows
from .range_search import (
    RangeConfig,
    RangeResult,
    range_search_compacted,
    range_search_fused,
)

@dataclasses.dataclass
class RangeSearchEngine:
    """An in-memory graph index over a corpus on one device: an (N, d) f32
    or bf16 tensor, an int8 ``QuantizedCorpus`` (codes + metadata + the raw
    f32 rows its rerank reads), or a ``TieredCorpus`` (the codes and
    metadata on the device, the raw rows in host memory). Every query runs
    on the engine's device. ``labels`` are the (N, W) packed per-point label
    rows (int32 words holding ``core.labels.pack_labels``' bits) or None;
    they gate only the result stage, so attaching them never changes an
    unfiltered answer."""

    points: Corpus          # (N, d) float32 / bfloat16, QuantizedCorpus or TieredCorpus
    graph: Graph
    start_ids: torch.Tensor # (S,) int32 search entry points
    labels: Optional[torch.Tensor] = None  # (N, W) int32 label words
    metric: str = "l2"

    @property
    def device(self) -> torch.device:
        return hot_arm(self.points).device

    # -- construction -------------------------------------------------------
    @staticmethod
    def build(points, build_cfg: Optional[BuildConfig] = None, metric: str = "l2",
              seed: int = 0, n_starts: int = 4, corpus_dtype: Optional[str] = None,
              labels=None, tier: bool = False, resident_mb: Optional[float] = None,
              device="cuda") -> "RangeSearchEngine":
        """Build a Vamana graph over ``points`` on ``device`` (exact f32
        vectors) and make the engine over it (``from_graph``)."""
        cfg = build_cfg or BuildConfig(metric=metric)
        graph = build_vamana(points, cfg, seed=seed, device=device)
        return RangeSearchEngine.from_graph(points, graph, metric=metric,
                                            n_starts=n_starts,
                                            corpus_dtype=corpus_dtype,
                                            labels=labels, tier=tier,
                                            resident_mb=resident_mb, device=device)

    @staticmethod
    def from_graph(points, graph: Graph, metric: str = "l2",
                   n_starts: int = 4, corpus_dtype: Optional[str] = None,
                   labels=None, tier: bool = False,
                   resident_mb: Optional[float] = None,
                   device="cuda") -> "RangeSearchEngine":
        """Engine over ``points`` (numpy or tensor) and a built ``graph``.
        Entry points are chosen on the f32 vectors; ``corpus_dtype``
        ("float32" | "bfloat16" | "int8") sets what the search stores and
        gathers. "int8" quantizes on the engine's device and keeps the raw
        f32 rows for the guard-band rerank; ``tier=True`` keeps those rows
        in (pinned) host memory instead, behind a device row cache of
        ``resident_mb`` MB (default n/8 rows), and defaults the dtype to
        int8. ``labels`` are (N, W) packed label rows (uint32 numpy from
        ``pack_labels``, or int32 words)."""
        dev = resolve_device(device)
        pts = torch.as_tensor(points, device=dev).float().contiguous()
        starts = start_points(pts, metric, n_starts)
        if tier:
            from ..tier import tiered_corpus   # core never imports tier otherwise
            pts = tiered_corpus(pts, corpus_dtype=corpus_dtype or "int8",
                                resident_mb=resident_mb, device=dev)
        elif corpus_dtype is not None:
            pts = corpus_cast(pts, corpus_dtype)
        if labels is not None:
            labels = as_label_rows(labels, dev).contiguous()
            if labels.shape[0] != corpus_size(pts):
                raise ValueError(f"labels rows ({labels.shape[0]}) != corpus size "
                                 f"({corpus_size(pts)})")
        nbrs = graph.neighbors.to(device=dev, dtype=torch.int32).contiguous()
        return RangeSearchEngine(points=pts, graph=Graph(neighbors=nbrs),
                                 start_ids=starts, labels=labels, metric=metric)

    # -- queries -------------------------------------------------------------
    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries).to(device=self.device,
                                           dtype=torch.float32).contiguous()

    def topk(self, queries, k: int = 10, cfg: Optional[SearchConfig] = None):
        cfg = cfg or SearchConfig(beam=max(2 * k, 32), max_beam=max(2 * k, 32),
                                  visit_cap=max(4 * k, 128), metric=self.metric)
        st = beam_search_batch(hot_arm(self.points), self.graph, self._queries(queries),
                               self.start_ids, float("inf"), cfg)
        return topk_from_state(st, k)

    def range(self, queries, r, *, cfg: Optional[RangeConfig] = None,
              es_radius=None, compacted: bool = True, tombstones=None,
              filter=None) -> RangeResult:
        """Range search. ``r`` (and ``es_radius``) is a scalar applied to
        every query or a ``(Q,)`` vector of per-query radii. ``tombstones``
        is a packed dead-slot bitset: deleted slots still route the
        traversal but never appear in results. ``filter`` is a per-query
        ``core.labels.LabelFilter`` over the engine's ``labels`` (required
        when filtering); points it rejects likewise route but never
        answer."""
        cfg = cfg or RangeConfig(search=SearchConfig(metric=self.metric))
        if cfg.search.metric != self.metric:
            cfg = dataclasses.replace(cfg, search=dataclasses.replace(
                cfg.search, metric=self.metric))
        if filter is not None and self.labels is None:
            raise ValueError("engine has no labels attached; build with labels= "
                             "to use filtered range search")
        with trace.span("range"):
            q = self._queries(queries)
            n = q.shape[0]
            r = broadcast_radius(r, n, device=self.device)
            if es_radius is not None:
                es_radius = broadcast_radius(es_radius, n, device=self.device)
            fn = range_search_compacted if compacted else range_search_fused
            return fn(corpus=self.points, graph=self.graph, queries=q,
                      start_ids=self.start_ids, r=r, cfg=cfg,
                      es_radius=es_radius, tombstones=tombstones,
                      labels=None if filter is None else self.labels,
                      label_filter=None if filter is None else filter.to(self.device))

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        deg = self.graph.degrees().float()
        out = dict(
            num_points=corpus_size(self.points),
            dim=corpus_dim(self.points),
            max_degree=int(self.graph.max_degree),
            mean_degree=float(deg.mean()),
            min_degree=int(deg.min()),
            metric=self.metric,
            corpus_dtype=corpus_dtype_name(self.points),
            hot_bytes_per_vector=bytes_per_vector(self.points),
        )
        if getattr(self.points, "is_tiered", False):
            out["tier"] = self.points.counters.as_dict()
            out["memory_budget"] = self.points.budget().as_dict()
        return out
