"""Multi-shard range retrieval: the production layout of the paper's engine.

A corpus bigger than one device splits into contiguous shards, each with
its *own* sub-index (graph + entry points). Range search then fans out over
a device mesh (``dist.sharding``'s SPMD contract, one rank per device):

* shards lay along the **model** axis (one or more sub-indices per rank),
  query batches along the **data** axis;
* each rank runs the fused single-batch search
  (``core.range_search_fused``) of its query block against each of its
  shards, and remaps shard-local ids to global ids by the shard's offset;
* one ``all_gather`` over the model axis (ids and distances packed in one
  int32 payload), concatenated in global shard order, then a distance-sort
  **union merge** gives each query its ``result_cap`` closest in-range
  points across all shards; one ``all_reduce`` sums the counts and the
  counters and ORs the flags (plus a union-level overflow when the merged
  count exceeds the cap); one ``all_gather`` over the data axis assembles
  the global batch, so every rank returns the same global ``RangeResult``.

Because the shards partition the corpus, per-shard result sets are disjoint
and the union needs no dedup, only the merge sort. The merge is a stable
sort on the distances alone (INVALID slots carry +inf), so ids come out in
the reference's order, not only as the same sets.

A ``ShardedCorpus`` built for a mesh (``build_sharded(..., mesh=)``,
``convert.sharded_from_arrays(..., mesh=)``) holds only the shards of its
rank's model coordinate, with their global offsets, the corpus size and the
total shard count; built without one it holds every shard, as the
reference's does, and also serves the host fan-out
(``fault.fault_tolerant_sharded_search``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.beam_search import _f32_ascending_key, broadcast_radius
from ..core.corpus import QuantizedCorpus, corpus_cast, pad_corpus_rows
from ..core.graph import Graph
from ..core.labels import LabelFilter, as_label_rows
from ..core.range_search import RangeConfig, RangeResult, range_search_fused
from ..utils import INVALID_ID, cdiv, resolve_device
from ._comm import all_gather, all_reduce_sum, axis_group
from .sharding import _axis_size


def _points_leaf(points) -> torch.Tensor:
    """A stacked corpus's representative tensor (the codes of a stacked
    ``QuantizedCorpus``)."""
    return points.codes if isinstance(points, QuantizedCorpus) else points


def _shard_points(points, i: int):
    """Held shard ``i`` of a stacked corpus (views, no copy)."""
    if isinstance(points, QuantizedCorpus):
        return QuantizedCorpus(codes=points.codes[i], meta=points.meta[i],
                               raw=None if points.raw is None else points.raw[i])
    return points[i]


def _stack(blocks):
    if isinstance(blocks[0], QuantizedCorpus):
        raw = [b.raw for b in blocks]
        return QuantizedCorpus(codes=torch.stack([b.codes for b in blocks]),
                               meta=torch.stack([b.meta for b in blocks]),
                               raw=None if raw[0] is None else torch.stack(raw))
    return torch.stack(blocks)


@dataclasses.dataclass
class ShardedCorpus:
    """Stacked per-shard sub-indices (leading axis: the held shards).

    ``points`` is a stacked (s, n, d) tensor or a ``QuantizedCorpus`` whose
    fields stack the held shards (codes (s, n, d), meta (s, n, 3), raw
    (s, n, d)); each shard quantizes *locally*, so its guard band is as
    tight as its own rows allow. ``first_shard`` and ``total_shards`` place
    the held shards among all S: a corpus built for a mesh holds
    ``total_shards / model axis size`` of them."""

    points: Any              # (s, n, d), pad rows unreachable
    neighbors: torch.Tensor  # (s, n, R) int32: per-shard adjacency
    start_ids: torch.Tensor  # (s, k) int32: per-shard entry points (local ids)
    offsets: torch.Tensor    # (s,) int32: global id of each held shard's row 0
    # the true corpus size, so pad-row ids (>= n_total) are droppable
    n_total: int
    # (s, n, W) int32 packed label rows (core.labels), or None. Pad rows of a
    # short last shard carry all-zero rows: unreachable, matching nothing.
    labels: Any = None
    # per-shard ``tier.TieredCorpus`` views (device None: the stacked points
    # are the device arm) or None; only the host fan-out searches them
    tiers: Any = None
    first_shard: int = 0                 # global index of the first held shard
    total_shards: Optional[int] = None   # S; None: every shard is held

    def __post_init__(self):
        if self.total_shards is None:
            self.total_shards = self.n_local

    @property
    def n_shards(self) -> int:
        """S, the corpus's shard count (held or not)."""
        return int(self.total_shards)

    @property
    def n_local(self) -> int:
        """The shards this corpus holds."""
        return _points_leaf(self.points).shape[0]

    @property
    def shard_size(self) -> int:
        return _points_leaf(self.points).shape[1]

    @property
    def device(self) -> torch.device:
        return _points_leaf(self.points).device


# Sentinel coordinates of the rows padding a short last shard. They never
# decide correctness: pad rows are appended after the sub-index is built on
# the real rows, so no edge and no entry point reaches them.
_FAR = 1e30


def _held_shards(mesh, n_shards: int, model_axis: str) -> range:
    """The shards of this rank's model coordinate (every shard without a
    mesh): ``shard_map``'s ``P(model_axis, ...)`` layout."""
    if mesh is None:
        return range(n_shards)
    n_model = _axis_size(mesh, model_axis)
    if n_shards % n_model:
        raise ValueError(f"{n_shards} shards do not lay out on model axis of "
                         f"size {n_model}")
    s_loc = n_shards // n_model
    m = int(mesh.get_local_rank(model_axis))
    return range(m * s_loc, (m + 1) * s_loc)


def build_sharded(
    points,
    n_shards: int,
    build_fn: Callable,   # (shard points (n, d) on the device) -> (Graph, start_ids (k,))
    lane_pad: int = 0,
    corpus_dtype: str = "float32",
    labels=None,
    tier: bool = False,
    resident_mb: float = None,
    *,
    mesh=None,
    model_axis: str = "model",
    device="cuda",
) -> ShardedCorpus:
    """Partition ``points`` ((N, d), numpy or a tensor) into ``n_shards``
    contiguous blocks and build one sub-index per block with ``build_fn``,
    which gets the block as an f32 tensor on ``device``. A short last block
    is padded to the common shard size only *after* its graph is built (FAR
    rows, INVALID adjacency, zero label rows), so no edge reaches a pad row.

    ``lane_pad > 0`` pads every sub-index's degree axis to that multiple
    (``Graph.lane_padded``). ``corpus_dtype`` "int8" quantizes each shard
    locally, before its pad rows are appended (``core.pad_corpus_rows``), so
    sentinel values cannot widen the band. ``labels`` is the corpus-wide
    (N, W) packed label matrix, split into the same blocks. ``tier=True``
    keeps each shard's raw rows in its own host store
    (``tier.tiered_corpus``; ``resident_mb`` caps each shard's device row
    cache) and the device arm in the stacked points; only the host fan-out
    serves a tiered corpus.

    With ``mesh``, only the shards of this rank's model coordinate are
    built and held (``ShardedCorpus.first_shard``/``total_shards`` place
    them); every rank passes the same ``points``."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points) if not isinstance(points, torch.Tensor)
                          else points)
    n_total, d = pts.shape
    n = cdiv(n_total, n_shards)
    if labels is not None:
        labels = as_label_rows(labels)
        if labels.shape[0] != n_total:
            raise ValueError(f"labels rows ({labels.shape[0]}) != corpus size ({n_total})")
    held = _held_shards(mesh, n_shards, model_axis)
    blocks, nbrs, starts, labs, tiers = [], [], [], [], []
    for s in held:
        block = pts[s * n:(s + 1) * n].to(device=dev, dtype=torch.float32).contiguous()
        graph, start_ids = build_fn(block)
        if lane_pad:
            graph = graph.lane_padded(lane_pad)
        neighbors = graph.neighbors.to(device=dev, dtype=torch.int32)
        n_pad = n - block.shape[0]
        stored = corpus_cast(block, corpus_dtype)
        if n_pad:  # pad points AND adjacency (INVALID = no edge)
            if corpus_dtype == "int8":
                stored = pad_corpus_rows(stored, n_pad, _FAR)
            else:
                stored = torch.cat([stored, torch.full((n_pad, d), _FAR, dtype=stored.dtype,
                                                       device=dev)])
            neighbors = torch.cat([neighbors, torch.full(
                (n_pad, neighbors.shape[1]), INVALID_ID, dtype=torch.int32, device=dev)])
        if tier:
            # the raw rows move to this shard's host store; the tier keeps no
            # device arm (the stacked points are it, sliced back per search)
            from ..tier import tiered_corpus
            t = tiered_corpus(stored, corpus_dtype=corpus_dtype, resident_mb=resident_mb,
                              device=dev)
            tiers.append(t.with_device(None))
            stored = t.device
        blocks.append(stored)
        nbrs.append(neighbors.contiguous())
        starts.append(torch.as_tensor(start_ids).to(device=dev, dtype=torch.int32).reshape(-1))
        if labels is not None:
            lab = labels[s * n:(s + 1) * n].to(dev)
            if n_pad:
                lab = torch.cat([lab, torch.zeros((n_pad, lab.shape[1]), dtype=torch.int32,
                                                  device=dev)])
            labs.append(lab)
    return ShardedCorpus(
        points=_stack(blocks),
        neighbors=torch.stack(nbrs),
        start_ids=torch.stack(starts),
        offsets=torch.tensor([s * n for s in held], dtype=torch.int32, device=dev),
        n_total=int(n_total),
        labels=None if labels is None else torch.stack(labs),
        tiers=tuple(tiers) if tier else None,
        first_shard=held.start,
        total_shards=n_shards,
    )


def _remap_global(ids: torch.Tensor, offset, n_total: int) -> torch.Tensor:
    """Shard-local ids -> global ids. INVALID padding stays INVALID, and so
    does anything past ``n_total`` (pad rows of a short last shard, which
    ``build_sharded`` makes unreachable)."""
    gids = torch.where(ids == INVALID_ID, INVALID_ID, ids + offset)
    return torch.where(gids < n_total, gids, INVALID_ID)


def union_merge(ids: torch.Tensor, dists: torch.Tensor, cap: int):
    """(Q, M) candidate ids/dists (INVALID/+inf padded, disjoint across
    sources) -> the ``cap`` closest per query, distance-sorted: a stable
    sort on the distances alone, in the total order of the reference's
    ``lax.sort`` (-0.0 before +0.0)."""
    order = torch.sort(_f32_ascending_key(dists), dim=1, stable=True).indices
    return (torch.gather(ids, 1, order)[:, :cap],
            torch.gather(dists, 1, order)[:, :cap])


def _shard_result(corpus: ShardedCorpus, i: int, queries, radii, cfg, es_vec,
                  tombstones, label_filter) -> RangeResult:
    """Held shard ``i``'s exact search with its ids remapped to global ids,
    INVALID slots at +inf and the count recounted after the remap: the
    per-shard program of both the collective path and the host fan-out. A
    tiered corpus (the fan-out only) composes the shard's host store back
    onto its slice of the stacked device arm, so its rerank fetches that
    shard's raw rows."""
    pts = _shard_points(corpus.points, i)
    if corpus.tiers is not None:
        pts = corpus.tiers[i].with_device(pts)
    res = range_search_fused(
        corpus=pts, graph=Graph(neighbors=corpus.neighbors[i]),
        queries=queries, start_ids=corpus.start_ids[i], r=radii, cfg=cfg,
        es_radius=es_vec,
        tombstones=None if tombstones is None else tombstones[corpus.first_shard + i],
        labels=None if label_filter is None else corpus.labels[i],
        label_filter=label_filter)
    gids = _remap_global(res.ids, corpus.offsets[i], corpus.n_total)
    return dataclasses.replace(
        res, ids=gids,
        dists=torch.where(gids == INVALID_ID, float("inf"), res.dists),
        count=torch.sum(gids != INVALID_ID, dim=1).to(torch.int32))


def _pad_rows(x: torch.Tensor, q_pad: int) -> torch.Tensor:
    """Replicate-pad a batch to ``q_pad`` rows with its first row."""
    n = x.shape[0]
    if q_pad == n:
        return x
    return torch.cat([x, x[:1].expand((q_pad - n,) + tuple(x.shape[1:]))])


def sharded_range_search(
    *,
    mesh,
    corpus: ShardedCorpus,
    queries,
    r,
    cfg: RangeConfig,
    es_radius: Optional[float] = None,
    tombstones=None,
    label_filter: Optional[LabelFilter] = None,
    model_axis: str = "model",
    data_axis: str = "data",
) -> RangeResult:
    """Union range search over every shard of ``corpus``; every rank of
    ``mesh`` makes the same call and gets the same global ``RangeResult``
    (corpus-global ids, counts summed across shards). ``corpus`` holds the
    shards of this rank's model coordinate.

    ``r``/``es_radius`` are a shared scalar or per-query ``(Q,)`` vectors;
    each shard answers every query at that query's own radius.
    ``tombstones`` is the stacked ``(S, W)`` dead-slot bitset, one per
    shard in shard-local slot space: each shard drops its own dead slots at
    its result stage, so counts and the merged top-``result_cap`` are
    live-only. ``label_filter`` is a per-query ``LabelFilter`` over the
    corpus's attached labels, evaluated by each shard at its result stage,
    so the merged result equals the post-filtered union."""
    if corpus.n_total <= 0:
        raise ValueError("ShardedCorpus.n_total must be the true corpus size")
    if corpus.tiers is not None:
        raise ValueError(
            "a tiered ShardedCorpus cannot run the collective program (host row "
            "fetches inside a collective would stall the mesh); use "
            "fault.fault_tolerant_sharded_search")
    if label_filter is not None and corpus.labels is None:
        raise ValueError("corpus has no labels attached; build_sharded(..., labels=) "
                         "to use filtered range search")
    held = _held_shards(mesh, corpus.n_shards, model_axis)
    if corpus.n_local != len(held) or corpus.first_shard != held.start:
        last = corpus.first_shard + corpus.n_local - 1
        raise ValueError(
            f"the corpus holds shards {corpus.first_shard}..{last} of {corpus.n_shards}, but "
            f"this rank's model coordinate holds {held.start}..{held.stop - 1}: build it for "
            "this mesh")
    cap = cfg.result_cap
    dev = corpus.device
    queries = torch.as_tensor(queries).to(device=dev, dtype=torch.float32)
    n_q = queries.shape[0]
    # radii as (Q,) vectors (es None -> +inf, which never stops a walk early)
    radii = broadcast_radius(r, n_q, device=dev)
    es_vec = broadcast_radius(es_radius, n_q, device=dev)
    masks = is_and = None
    if label_filter is not None:
        masks = label_filter.masks.to(dev)
        is_and = label_filter.is_and.to(dev)
        if masks.shape[0] != n_q:
            raise ValueError(f"label_filter covers {masks.shape[0]} lanes for {n_q} queries")
    if tombstones is not None:
        tombstones = as_label_rows(tombstones, dev)   # (S, W) int32 words
    # the data axis: replicate-pad the batch to its multiple, take this
    # rank's block
    n_data = _axis_size(mesh, data_axis)
    q_loc = cdiv(n_q, n_data)
    lo = int(mesh.get_local_rank(data_axis)) * q_loc
    blk = slice(lo, lo + q_loc)
    qs, rs, es = (_pad_rows(x, q_loc * n_data)[blk] for x in (queries, radii, es_vec))
    filt = None if masks is None else LabelFilter(
        masks=_pad_rows(masks, q_loc * n_data)[blk],
        is_and=_pad_rows(is_and, q_loc * n_data)[blk])

    per = [_shard_result(corpus, i, qs, rs, cfg, es, tombstones, filt)
           for i in range(corpus.n_local)]
    # the model axis: every shard's candidates in global shard order
    model = axis_group(mesh, model_axis)
    local = torch.cat([torch.cat([p.ids for p in per], 1),
                       torch.cat([p.dists for p in per], 1).view(torch.int32)], 1)
    width = local.shape[1] // 2
    parts = all_gather(local, model)
    ids, dists = union_merge(torch.cat([p[:, :width] for p in parts], 1),
                             torch.cat([p[:, width:] for p in parts], 1).view(torch.float32),
                             cap)
    stats = torch.stack([
        sum(p.count for p in per), sum(p.overflow.to(torch.int32) for p in per),
        sum(p.n_visited for p in per), sum(p.n_dist for p in per),
        sum(p.es_stopped.to(torch.int32) for p in per),
        sum(p.phase2.to(torch.int32) for p in per), sum(p.n_rerank for p in per)])
    total, over, nvis, ndis, ess, ph2, nrr = all_reduce_sum(stats.to(torch.int32), model)
    stats = torch.stack([torch.minimum(total, torch.full_like(total, cap)),
                         ((over > 0) | (total > cap)).to(torch.int32), nvis, ndis,
                         (ess > 0).to(torch.int32), (ph2 > 0).to(torch.int32), nrr])
    # the data axis: every block, in order, cut back to the batch
    block = torch.cat([ids, dists.view(torch.int32), stats.T], 1)
    out = torch.cat(all_gather(block.contiguous(), axis_group(mesh, data_axis)))[:n_q]
    cols = out[:, 2 * cap:].T
    return RangeResult(
        ids=out[:, :cap].contiguous(),
        dists=out[:, cap:2 * cap].contiguous().view(torch.float32),
        count=cols[0].contiguous(), overflow=cols[1] > 0,
        n_visited=cols[2].contiguous(), n_dist=cols[3].contiguous(),
        es_stopped=cols[4] > 0, phase2=cols[5] > 0, n_rerank=cols[6].contiguous())
