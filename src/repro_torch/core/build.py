"""Graph construction: the Vamana (DiskANN) batch build, and a brute-force
k-NN graph.

The Vamana build is the reference's fixed-shape batched dataflow, run on
the engine's device:

* prefix-doubling insert batches (points in a seeded random order; each
  batch searches the current graph, RobustPrunes what it visited, then
  pushes reverse edges, pruned again where a row overflows);
* RobustPrune (α-domination) batched over rows: R masked-argmin steps, each
  an α test of every candidate against the one just selected;
* reverse edges grouped by a stable sort on the destination and run-start
  arithmetic (the fixed-shape stand-in for a per-node append).

The searches run the engine's own beam search, so every insert batch
launches the expand and gatherdist kernels on a CUDA corpus.

One departure from the reference: its batches are padded with INVALID ids
whose lanes scatter node 0's old row back over any update to node 0 in the
same batch (duplicate scatter indices; on its CPU backend the last write
wins). Here only the batch's real rows are searched, pruned and written.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..utils import INVALID_ID, resolve_device
from .beam_search import SearchConfig, beam_search_batch
from .distances import gather_dist, point_dist
from .graph import Graph, medoid
from .ground_truth import exact_topk

# overflowing rows of the reverse-edge fix pruned at once: (chunk,
# R + rev_cap, d) f32 candidate rows, 335 MB at R=32, d=128. A 1M build's
# batches overflow ~12,000 rows; the prune is host-bound (~17 launches a
# step), so fewer, wider chunks cost less
FIX_CHUNK = 16384


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    max_degree: int = 32     # R
    beam: int = 64           # L_build
    alpha: float = 1.2
    insert_batch: int = 1024 # widest insert batch
    rev_cap: int = 8         # reverse-edge candidates accepted per node per batch
    two_pass: bool = False   # DiskANN's alpha=1.0 first pass
    metric: str = "l2"

    @property
    def search_cfg(self) -> SearchConfig:
        return SearchConfig(beam=self.beam, max_beam=self.beam,
                            visit_cap=max(2 * self.beam, 128), metric=self.metric)


# ---------------------------------------------------------------------------
# RobustPrune
# ---------------------------------------------------------------------------

def robust_prune(points: torch.Tensor, p_vec: torch.Tensor,
                 cand_ids: torch.Tensor, cand_dists: torch.Tensor,
                 alpha: float, R: int, metric: str = "l2",
                 self_id: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vamana RobustPrune over a batch of rows: ``p_vec`` (B, d) the nodes
    being pruned, ``cand_ids``/``cand_dists`` (B, C) their candidates (may
    hold INVALID, duplicates and the node itself) and exact distances to
    it, ``self_id`` (B,). Returns (B, R) selected out-neighbours, INVALID
    padded. Each step takes the closest remaining candidate (the first on a
    tie, as ``argmin`` does in both frameworks) and drops every candidate
    v with α·d(sel, v) <= d(p, v); α applies at l2 only (ip distances are
    negative)."""
    b, c = cand_ids.shape
    dev = cand_ids.device
    valid = cand_ids != INVALID_ID
    if self_id is not None:
        valid &= cand_ids != self_id[:, None]
    order = torch.arange(c, device=dev)
    dup = torch.any((cand_ids[:, :, None] == cand_ids[:, None, :])
                    & (order[None, :] < order[:, None])[None] & valid[:, :, None], dim=2)
    valid &= ~dup
    dists = torch.where(valid, cand_dists, torch.inf)
    cvecs = points[torch.where(valid, cand_ids, 0).long()].float()    # (B, C, d)
    a = alpha if metric == "l2" else 1.0
    rows = torch.arange(b, device=dev)
    mask = valid
    out = torch.full((b, R), INVALID_ID, dtype=torch.int32, device=dev)
    for i in range(R):
        d_masked = torch.where(mask, dists, torch.inf)
        j = torch.argmin(d_masked, dim=1)
        ok = torch.isfinite(d_masked[rows, j])
        out[:, i] = torch.where(ok, cand_ids[rows, j], INVALID_ID)
        d_sel = point_dist(cvecs, cvecs[rows, j][:, None, :], metric)  # (B, C)
        mask = mask & ~(a * d_sel <= dists) & ok[:, None]
        mask[rows, j] = False
    return out


# ---------------------------------------------------------------------------
# Reverse-edge packing
# ---------------------------------------------------------------------------

def _pack_reverse(dst_flat: torch.Tensor, src_flat: torch.Tensor, rev_cap: int):
    """Group (dst, src) edge pairs by dst: ``(unique_dst (M,), rev_srcs (M,
    rev_cap))``, M = len(dst_flat), INVALID padded; one row a run start, at
    most ``rev_cap`` sources a dst, in the pairs' order."""
    order = torch.argsort(dst_flat, stable=True)
    dst, src = dst_flat[order], src_flat[order]
    m = dst.shape[0]
    idx = torch.arange(m, device=dst.device)
    is_start = torch.ones(m, dtype=torch.bool, device=dst.device)
    is_start[1:] = dst[1:] != dst[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    uniq_dst = torch.where(is_start & (dst != INVALID_ID), dst, INVALID_ID)
    take = torch.clamp(run_start[:, None] + torch.arange(rev_cap, device=dst.device),
                       max=m - 1)
    ok = ((dst[take] == dst[:, None]) & is_start[:, None]
          & (dst[:, None] != INVALID_ID))
    return uniq_dst, torch.where(ok, src[take], INVALID_ID)


# ---------------------------------------------------------------------------
# Batch insert
# ---------------------------------------------------------------------------

def _fix_rows(points, nbr_rows, dst, revs, alpha: float, R: int, metric: str,
              use_kernels: bool) -> torch.Tensor:
    """New rows of ``dst`` (U,) given their reverse-edge sources ``revs``
    (U, rev_cap): the current row merged with the sources (duplicates and
    self dropped); a row that fits R keeps its ids in ascending order, one
    that overflows is RobustPruned (those rows only, ``FIX_CHUNK`` at a
    time)."""
    merged = torch.cat([nbr_rows[dst.long()], revs], 1)               # (U, R + cap)
    order = torch.arange(merged.shape[1], device=merged.device)
    m_valid = (merged != INVALID_ID) & (merged != dst[:, None])
    dup = torch.any((merged[:, :, None] == merged[:, None, :])
                    & (order[None, :] < order[:, None])[None] & m_valid[:, :, None], dim=2)
    m_valid &= ~dup
    merged = torch.where(m_valid, merged, INVALID_ID)
    rows = torch.sort(merged, dim=1).values[:, :R].contiguous()
    over = torch.nonzero(torch.sum(m_valid, dim=1) > R).flatten()
    for a in range(0, over.numel(), FIX_CHUNK):
        sel = over[a:a + FIX_CHUNK]
        d, cand = dst[sel], merged[sel]
        pvec = points[d.long()]
        dists = gather_dist(points, cand, pvec, metric, use_kernels)
        rows[sel] = robust_prune(points, pvec, cand, dists, alpha, R, metric, self_id=d)
    return rows


def insert_batch_step(points: torch.Tensor, nbr_rows: torch.Tensor, batch_ids,
                      start_ids, cfg: BuildConfig, alpha: float, *,
                      timings: Optional[dict] = None) -> torch.Tensor:
    """One Vamana insert batch: search + RobustPrune + reverse edges with
    overflow pruning. ``points`` (N, d) f32 must already hold the batch's
    rows; ``nbr_rows`` (N, R) int32 is the current adjacency (not
    modified; the new one is returned); ``batch_ids`` (B,) may be padded
    with INVALID; ``start_ids`` (S,) are the search's entry points.
    ``timings`` (a dict) accumulates the seconds of the search, the prune
    and the reverse edges (synchronizing the device at each boundary)."""
    dev = points.device
    R = cfg.max_degree
    batch_ids = torch.as_tensor(batch_ids).to(device=dev, dtype=torch.int32)
    ids = batch_ids[batch_ids != INVALID_ID]
    nbr_rows = nbr_rows.clone()
    if ids.numel() == 0:
        return nbr_rows
    clock = _Clock(timings, dev)

    # 1. search the current graph from the entry points (the medoid at build)
    qs = points[ids.long()]
    st = beam_search_batch(points, Graph(neighbors=nbr_rows), qs,
                           torch.as_tensor(start_ids).to(dev), float("inf"),
                           cfg.search_cfg)
    clock.lap("search")

    # 2. RobustPrune over visited + beam, written to the batch's rows
    new_rows = robust_prune(points, qs,
                            torch.cat([st.visited_ids, st.ids], 1),
                            torch.cat([st.visited_dists, st.dists], 1),
                            alpha, R, cfg.metric, self_id=ids)
    nbr_rows[ids.long()] = new_rows
    clock.lap("prune")

    # 3. reverse edges: candidate (dst = new neighbour, src = inserted point)
    dst_flat = new_rows.reshape(-1)
    src_flat = torch.where(dst_flat != INVALID_ID,
                           ids[:, None].expand(-1, R).reshape(-1), INVALID_ID)
    uniq_dst, rev_srcs = _pack_reverse(dst_flat, src_flat, cfg.rev_cap)
    keep = uniq_dst != INVALID_ID
    uniq_dst, rev_srcs = uniq_dst[keep], rev_srcs[keep]

    # 4. merge the destinations' rows, prune those that overflow, write them
    nbr_rows[uniq_dst.long()] = _fix_rows(points, nbr_rows, uniq_dst, rev_srcs,
                                          alpha, R, cfg.metric, cfg.search_cfg.use_kernels)
    clock.lap("reverse")
    return nbr_rows


class _Clock:
    """Accumulates the seconds between laps into ``timings`` (nothing when
    it is None)."""

    def __init__(self, timings: Optional[dict], dev: torch.device):
        self.timings, self.dev = timings, dev
        if timings is not None:
            self._sync()
            self.t = time.perf_counter()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def lap(self, name: str) -> None:
        if self.timings is None:
            return
        self._sync()
        t = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + (t - self.t)
        self.t = t


def build_vamana(points, cfg: BuildConfig = BuildConfig(), seed: int = 0,
                 verbose: bool = False, device="cuda",
                 timings: Optional[dict] = None) -> Graph:
    """Prefix-doubling Vamana batch build (ParlayANN style) on ``device``:
    points inserted in ``np.random.default_rng(seed)``'s permutation, in
    batches of 64, 128, ... up to ``cfg.insert_batch``, each searching from
    the medoid; the medoid starts with edges to the first R points of the
    order. ``timings`` accumulates the split of the insert batches."""
    dev = resolve_device(device)
    pts = torch.as_tensor(points).to(device=dev, dtype=torch.float32).contiguous()
    n = pts.shape[0]
    order = np.random.default_rng(seed).permutation(n).astype(np.int32)
    start = medoid(pts)
    nbr_rows = torch.full((n, cfg.max_degree), INVALID_ID, dtype=torch.int32, device=dev)
    seed_ids = torch.from_numpy(order[:cfg.max_degree]).to(dev)
    nbr_rows[start.long()] = torch.where(seed_ids == start, INVALID_ID, seed_ids)

    passes = [1.0, cfg.alpha] if cfg.two_pass else [cfg.alpha]
    B = cfg.insert_batch
    for alpha in passes:
        done = 0
        bsize = max(1, min(64, B))
        while done < n:
            take = min(bsize, n - done, B)
            batch = torch.from_numpy(order[done:done + take]).to(dev)
            nbr_rows = insert_batch_step(pts, nbr_rows, batch, start[None], cfg,
                                         alpha, timings=timings)
            done += take
            bsize = min(bsize * 2, B)
            if verbose:
                print(f"  [build alpha={alpha}] inserted {done}/{n}")
    return Graph(neighbors=nbr_rows)


def build_knn_graph(points, k: int = 16, metric: str = "l2", mutual: bool = False,
                    device="cuda", block: int = 16384,
                    query_block: int = 8192) -> Graph:
    """Brute-force k-NN graph: each node's k nearest other nodes.
    ``mutual`` is taken and ignored, as the reference does."""
    ids, _ = exact_topk(points, points, k=k + 1, metric=metric, block=block,
                        query_block=query_block, device=device)
    # drop the self column: move self (if present) to the end, take k
    row = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)[:, None]
    col = torch.arange(k + 1, device=ids.device)[None, :]
    sort_key = torch.where(ids != row, col, k + 1)
    order = torch.argsort(sort_key, dim=1, stable=True)
    return Graph(neighbors=torch.gather(ids, 1, order)[:, :k].contiguous())
