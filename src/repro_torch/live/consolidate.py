"""Consolidation: rewire around tombstones, then compact.

FreshDiskANN-style delete processing, as the reference does it:

1. **Delete-aware rewiring.** For every live node with at least one
   tombstoned out-neighbour, the new candidates are its live one-hop
   neighbours plus the live neighbours of each dead neighbour (the patch
   through a routing node that leaves), deduplicated with the first
   occurrence winning. A candidate set that fits the degree bound is kept
   (ids ascending); one that overflows goes through RobustPrune against
   exact distances, the pruning of the build and the insert path.
2. **Compaction.** Live rows move to the front of the capacity (slots
   change; external ids, owned by ``LiveIndex``, do not), neighbour ids are
   remapped, freed slots return to the unborn-sentinel state, entry points
   are chosen again over the surviving rows, and the tombstones reset.

Two departures from the reference, neither of which changes a row: the
candidates are built on the index's device (a stable sort for the dedup),
a chunk of rows at a time, where the reference builds them in host numpy;
and the overflowing rows are pruned in chunks sized by the largest
candidate count, each row's candidates packed to the front in order first,
with no power-of-two bucket padding (eager PyTorch compiles nothing per
shape).
RobustPrune takes the first of tied candidates in candidate order, and
INVALID entries never win, so the packing cannot move a selection.

Two consecutive tombstoned hops are not patched through (single-hop
patching, as in FreshDiskANN): a lost edge costs a little recall until the
next insert or consolidation, never correctness, since results are filtered
against the exact live set.
"""
from __future__ import annotations

import torch

from ..core.build import BuildConfig, robust_prune
from ..core.corpus import Corpus, corpus_raw, corpus_size, corpus_take_rows, corpus_with_capacity
from ..core.distances import gather_dist
from ..core.graph import start_points
from ..utils import INVALID_ID

# rows whose candidate lists (R + R*R int32 each, plus the dedup sort's
# int64 order) are built at once: ~35M entries at R=32
REWIRE_ROWS = 32768
# bytes a prune chunk may hold in candidate rows (4 d a candidate) and in
# RobustPrune's (C, C) duplicate matrix
PRUNE_BYTES = 1 << 29


def _prune_rows(points: torch.Tensor, node_ids: torch.Tensor, cand: torch.Tensor,
                cfg: BuildConfig) -> torch.Tensor:
    """RobustPrune (P, C) candidate rows (deduplicated, self-free, live
    only, INVALID holes) down to (P, R), against exact distances to each
    row's node ``node_ids`` (P,)."""
    p, d = cand.shape[0], points.shape[1]
    valid = cand != INVALID_ID
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    cand = torch.gather(cand, 1, order)                 # valid ones first, in order
    counts = valid.sum(1)
    c_max = max(1, int(counts.max()))
    rows = max(1, PRUNE_BYTES // (c_max * (c_max + 4 * d)))
    out = torch.empty((p, cfg.max_degree), dtype=torch.int32, device=cand.device)
    for a in range(0, p, rows):
        c = max(1, int(counts[a:a + rows].max()))
        nid, row = node_ids[a:a + rows], cand[a:a + rows, :c].contiguous()
        pvec = points[nid.long()]
        dists = gather_dist(points, row, pvec, cfg.metric, cfg.search_cfg.use_kernels)
        out[a:a + rows] = robust_prune(points, pvec, row, dists, cfg.alpha,
                                       cfg.max_degree, cfg.metric, self_id=nid)
    return out


def _candidates(nbrs: torch.Tensor, dead: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """(p, R + R*R) candidates of rows ``ix``: live one-hop neighbours, then
    the live neighbours of each dead neighbour, self and later duplicates
    set to INVALID in place (the reference's layout)."""
    p = ix.shape[0]
    sub = nbrs[ix]
    sub_valid = sub != INVALID_ID
    sub_safe = torch.where(sub_valid, sub, 0).long()
    sub_dead = sub_valid & dead[sub_safe]
    one_hop = torch.where(sub_valid & ~sub_dead, sub, INVALID_ID)
    hop2 = torch.where(sub_dead[:, :, None], nbrs[sub_safe], INVALID_ID).reshape(p, -1)
    h_valid = hop2 != INVALID_ID
    hop2 = torch.where(h_valid & ~dead[torch.where(h_valid, hop2, 0).long()], hop2, INVALID_ID)
    cand = torch.cat([one_hop, hop2], 1)
    cand = torch.where(cand == ix[:, None], INVALID_ID, cand)
    # per-row dedup, the first occurrence wins: stable sort, adjacent compare
    srt, order = torch.sort(cand, dim=1, stable=True)
    dup_sorted = torch.zeros_like(cand, dtype=torch.bool)
    dup_sorted[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != INVALID_ID)
    dup = torch.zeros_like(dup_sorted).scatter(1, order, dup_sorted)
    return torch.where(dup, INVALID_ID, cand)


def _rewire(nbrs: torch.Tensor, dead: torch.Tensor, live_count: int,
            points: torch.Tensor, cfg: BuildConfig) -> tuple[torch.Tensor, dict]:
    """Replace the dead out-neighbours of live rows by patching through to
    their live neighbours. ``dead`` is the (N_cap,) bool mask on the
    device; returns (new adjacency, counts)."""
    n_cap, R = nbrs.shape
    valid = nbrs != INVALID_ID
    nbr_dead = valid & dead[torch.where(valid, nbrs, 0).long()]
    born = torch.arange(n_cap, device=nbrs.device) < live_count
    idx = torch.nonzero(born & ~dead & nbr_dead.any(1)).flatten()
    if idx.numel() == 0:
        return nbrs, dict(n_rewired=0, n_pruned=0)
    out = nbrs.clone()
    n_pruned = 0
    for a in range(0, idx.numel(), REWIRE_ROWS):
        ix = idx[a:a + REWIRE_ROWS]
        cand = _candidates(nbrs, dead, ix)
        fits = (cand != INVALID_ID).sum(1) <= R
        # rows that still fit keep their candidates, ids ascending
        out[ix[fits]] = torch.sort(cand[fits], dim=1).values[:, :R]
        over = torch.nonzero(~fits).flatten()
        if over.numel():
            out[ix[over]] = _prune_rows(points, ix[over].to(torch.int32), cand[over], cfg)
            n_pruned += over.numel()
    return out, dict(n_rewired=int(idx.numel()), n_pruned=n_pruned)


def consolidate_index(points: Corpus, neighbors: torch.Tensor, dead, live_count: int,
                      cfg: BuildConfig, metric: str, n_starts: int, far: float = 1e30):
    """A full consolidation pass on the index's device. ``dead`` is the
    (N_cap,) bool mask of tombstoned slots (numpy or a tensor).

    Returns ``(points, neighbors, start_ids, perm, stats)``: ``perm`` (numpy,
    (n_live,)) lists the OLD slots of the surviving rows in their new slot
    order (new slot i holds old slot perm[i]), for the caller's slot-keyed
    host metadata (external ids, label rows)."""
    capacity = corpus_size(points)
    raw = corpus_raw(points)
    dev = neighbors.device
    dead = torch.as_tensor(dead, device=dev).bool()
    rewired, stats = _rewire(neighbors, dead, live_count, raw, cfg)

    born = torch.arange(capacity, device=dev) < live_count
    perm = torch.nonzero(born & ~dead).flatten()
    n_live = perm.numel()
    if n_live == 0:
        raise ValueError("consolidation would empty the index")
    mapping = torch.full((capacity,), INVALID_ID, dtype=torch.int32, device=dev)
    mapping[perm] = torch.arange(n_live, dtype=torch.int32, device=dev)
    sub = rewired[perm]
    sub_valid = sub != INVALID_ID
    # dead or unborn targets map to INVALID (a defence: rewiring left none)
    new_rows = torch.where(sub_valid, mapping[torch.where(sub_valid, sub, 0).long()], INVALID_ID)
    new_nbrs = torch.full((capacity, neighbors.shape[1]), INVALID_ID, dtype=torch.int32,
                          device=dev)
    new_nbrs[:n_live] = new_rows

    live_pts = corpus_take_rows(points, perm)
    new_points = corpus_with_capacity(live_pts, capacity, far)
    new_starts = start_points(corpus_raw(live_pts).float(), metric, n_starts)
    return new_points, new_nbrs, new_starts, perm.cpu().numpy(), stats
