"""Range-retrieval algorithms on top of the beam search (paper Algs. 2/5/6).

Three modes, matching the paper:

* ``"beam"``     — the naive baseline: one beam search, filter the beam by r.
* ``"doubling"`` — Alg. 5: survivors restart with in-place beam widening.
* ``"greedy"``   — Alg. 6: lanes whose beam is saturated with in-range
  results continue with Alg. 2 (expand only in-range nodes, into a
  fixed-capacity result buffer with an overflow flag).

``range_search_compacted`` is the two-phase path: phase 1 over the whole
batch, phase 2 only over the lanes that need it. ``range_search_fused``
runs phase 2 masked over every lane instead. Both take an f32/bf16 corpus
or an int8 ``QuantizedCorpus``; the latter searches on certified lower
bounds and ends in the guard-band rerank. A ``TieredCorpus`` (``tier``)
walks on its device arm and serves the rerank's exact rows from host
memory. Label predicates gate the result stage; on the compacted path a
lane whose predicate is selective enough skips the graph and scans its
posting list exactly. ``greedy_seed_batch`` / ``greedy_resume_batch``
expose phase 2 as checkpoints advanced in slices, for continuous batching
(``serve.scheduler``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import trace
from ..kernels.rerank_fetch import fetch_rerank_pairs
from ..utils import INVALID_ID
from .beam_search import (
    BeamState,
    SearchConfig,
    _expand_tile,
    _f32_ascending_key,
    _f32_from_key,
    _sort_by_dist,
    beam_search_batch,
    broadcast_radius,
    in_range_count,
    keep_walking,
)
from .bitset import (
    bitset_add,
    bitset_contains,
    bitset_exact,
    bitset_init,
    bitset_num_words,
    first_slot_occurrence,
)
from .corpus import QuantizedCorpus, corpus_raw, corpus_size, hot_arm, upper_bound_dists
from .distances import gather_dist
from .graph import Graph
from .labels import LabelFilter, as_label_rows, label_match_counts, labels_match

@dataclasses.dataclass(frozen=True)
class RangeConfig:
    """Configuration for a range query batch."""

    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    mode: str = "greedy"          # beam | doubling | greedy
    result_cap: int = 1024        # K_cap: per-query result buffer
    frontier_rounds: int = 4096   # greedy expansion budget (expansions/query)
    lam: float = 1.0              # λ threshold for entering phase 2
    # int8 corpus: exact-rerank the guard band after the approximate search
    # (the corpus must carry raw rows). False keeps the certified superset.
    rerank: bool = True
    # filtered search: a lane whose predicate matches fewer than this
    # fraction of the corpus scans its posting list exactly instead of
    # walking (compacted path only; 0 disables the fallback)
    filter_threshold: float = 0.0

    def __post_init__(self):
        if self.mode not in ("beam", "doubling", "greedy"):
            raise ValueError(f"bad mode {self.mode!r}")
        if self.mode == "doubling" and self.search.max_beam <= self.search.beam:
            raise ValueError("doubling mode needs search.max_beam > search.beam")
        if not 0.0 <= self.filter_threshold <= 1.0:
            raise ValueError("filter_threshold must be in [0, 1]")


@dataclasses.dataclass
class RangeResult:
    """Batched range-query output (INVALID / +inf padded)."""

    ids: torch.Tensor       # (Q, K) int32
    dists: torch.Tensor     # (Q, K) float32
    count: torch.Tensor     # (Q,) int32 — number of valid entries
    overflow: torch.Tensor  # (Q,) bool — K_cap or budget exceeded
    n_visited: torch.Tensor # (Q,) int32 — phase-1 expansions
    n_dist: torch.Tensor    # (Q,) int32 — total distance computations
    es_stopped: torch.Tensor  # (Q,) bool
    phase2: torch.Tensor    # (Q,) bool — query took the second phase
    n_rerank: torch.Tensor  # (Q,) int32 — guard-band candidates exact-reranked

    def select(self, lanes: torch.Tensor) -> "RangeResult":
        """The result of the given lanes (an index tensor)."""
        return RangeResult(**{f.name: getattr(self, f.name)[lanes]
                              for f in dataclasses.fields(self)})


# ---------------------------------------------------------------------------
# Greedy continuation (paper Alg. 2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GreedyState:
    res_ids: torch.Tensor    # (Q, K) int32 — every id here is in range
    res_dists: torch.Tensor  # (Q, K) float32
    res_count: torch.Tensor  # (Q,) int32
    expand_ptr: torch.Tensor # (Q,) int32
    rounds: torch.Tensor     # (Q,) int32
    overflow: torch.Tensor   # (Q,) bool
    n_dist: torch.Tensor     # (Q,) int32
    seen_bits: torch.Tensor  # (Q, W) int32 — result-membership bitset

    def select(self, lanes: torch.Tensor) -> "GreedyState":
        """The state of the given lanes (an index tensor; copies)."""
        return GreedyState(**{f.name: getattr(self, f.name)[lanes]
                              for f in dataclasses.fields(self)})


def _greedy_init(st: BeamState, r, cap: int, num_words: int,
                 exact_bits: bool) -> GreedyState:
    """Seed the result buffer with every in-range node whose exact distance
    is already known: the visited log plus the unexpanded in-range beam
    entries (disjoint by construction), closest first, mirrored into a
    membership bitset."""
    rq = r[:, None]
    v_ok = st.visited_dists <= rq
    b_ok = (st.dists <= rq) & ~st.expanded & (st.ids != INVALID_ID)
    ids = torch.cat([torch.where(v_ok, st.visited_ids, INVALID_ID),
                     torch.where(b_ok, st.ids, INVALID_ID)], 1)
    dists = torch.cat([torch.where(v_ok, st.visited_dists, torch.inf),
                       torch.where(b_ok, st.dists, torch.inf)], 1)
    dists, ids = _sort_by_dist(dists, ids)
    qn, dev = ids.shape[0], ids.device
    k = min(cap, ids.shape[1])
    res_ids = torch.full((qn, cap), INVALID_ID, dtype=torch.int32, device=dev)
    res_ids[:, :k] = ids[:, :k]
    res_dists = torch.full((qn, cap), torch.inf, device=dev)
    res_dists[:, :k] = dists[:, :k]
    total = torch.sum(torch.isfinite(dists), dim=1, dtype=torch.int32)
    bits = bitset_init(num_words, qn, dev)
    seed_ok = res_ids != INVALID_ID  # unique ids by construction
    if not exact_bits:  # hashed regime: collapse colliding buckets first
        seed_ok = first_slot_occurrence(bits, res_ids, seed_ok)
    bitset_add(bits, res_ids, seed_ok)
    zi = torch.zeros(qn, dtype=torch.int32, device=dev)
    return GreedyState(res_ids=res_ids, res_dists=res_dists,
                       res_count=torch.clamp(total, max=cap), expand_ptr=zi,
                       rounds=zi, overflow=total > cap, n_dist=zi,
                       seen_bits=bits)


def _append(buf: torch.Tensor, write_pos: torch.Tensor, rows: torch.Tensor):
    """Scatter ``rows`` (Q, T, ...) into ``buf`` (Q, K, ...) at ``write_pos``
    (Q, T); position K drops the row (a scratch slot, sliced off)."""
    pad = torch.zeros_like(buf[:, :1])
    idx = write_pos.long().view(*write_pos.shape, *([1] * (rows.dim() - 2)))
    out = torch.cat([buf, pad], 1).scatter(1, idx.expand_as(rows), rows)
    return out[:, :-1]


def _greedy_step_reference(points, graph: Graph, q, r, cap: int,
                           scfg: SearchConfig, gs: GreedyState,
                           exact_bits: bool, live) -> GreedyState:
    """Single-node greedy step (``expand_width=1``), the pre-fusion
    dataflow. With an exact bitset the membership probe is the bitset
    (identical to the result-buffer broadcast, since the bitset mirrors the
    buffer); in the hashed regime it is the paper-faithful broadcast."""
    node = torch.gather(gs.res_ids, 1,
                        torch.clamp(gs.expand_ptr, max=cap - 1).long()[:, None])[:, 0]
    nbrs = graph.out_neighbors(torch.where(live, node, INVALID_ID))    # (Q, R)
    nd = gather_dist(points, nbrs, q, scfg.metric, scfg.use_kernels)
    rr = torch.arange(nbrs.shape[1], device=q.device)
    ok = nbrs != INVALID_ID
    dup_in_row = torch.any((nbrs[:, :, None] == nbrs[:, None, :])
                           & (rr[None, None, :] < rr[None, :, None])
                           & ok[:, :, None], dim=2)
    if exact_bits:
        seen = bitset_contains(gs.seen_bits, torch.where(ok, nbrs, 0))
    else:
        seen = torch.any((nbrs[:, :, None] == gs.res_ids[:, None, :])
                         & ok[:, :, None], dim=2)
    new = (nd <= r[:, None]) & ~dup_in_row & ~seen & ok
    pos = gs.res_count[:, None] + torch.cumsum(new, dim=1, dtype=torch.int32) - 1
    write_pos = torch.where(new & (pos < cap), pos, cap)
    n_new = torch.sum(new, dim=1, dtype=torch.int32)
    if exact_bits:
        bitset_add(gs.seen_bits, nbrs, new)
    step = live.to(torch.int32)
    return GreedyState(
        res_ids=_append(gs.res_ids, write_pos, nbrs),
        res_dists=_append(gs.res_dists, write_pos, nd),
        res_count=torch.clamp(gs.res_count + n_new, max=cap),
        expand_ptr=gs.expand_ptr + step,
        rounds=gs.rounds + step,
        overflow=gs.overflow | (gs.res_count + n_new > cap),
        n_dist=gs.n_dist + torch.sum(ok, dim=1, dtype=torch.int32),
        seen_bits=gs.seen_bits)


def _pack(ids: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """[id, distance key] rows, (Q, K, 2) int32 (the key wraps to int32)."""
    return torch.stack([ids, _f32_ascending_key(dists).to(torch.int32)], -1)


def _unpack(res: torch.Tensor):
    return res[..., 0], _f32_from_key(res[..., 1].to(torch.int64) & 0xFFFFFFFF)


def _greedy_step(points, graph: Graph, q, r, cap: int, scfg: SearchConfig,
                 gs: GreedyState, res: torch.Tensor, live) -> tuple:
    """Expand the next E result-buffer entries of every live lane through
    the fused expand kernel, appending fresh in-range neighbors to the
    packed [id, key] buffer ``res`` in one scatter. Returns (state, res)."""
    E = scfg.eff_expand_width
    lane = torch.arange(E, device=q.device)
    e_cnt = torch.clamp(gs.res_count - gs.expand_ptr, max=E)
    lane_ok = (lane[None] < e_cnt[:, None]) & live[:, None]
    ridx = torch.clamp(gs.expand_ptr[:, None] + lane, max=cap - 1).long()
    nodes = torch.where(lane_ok, torch.gather(res[..., 0], 1, ridx), INVALID_ID)

    nbr_ids, nd, nd_inc = _expand_tile(points, graph, nodes.contiguous(), q,
                                       scfg)
    valid = nbr_ids != INVALID_ID
    seen = bitset_contains(gs.seen_bits, torch.where(valid, nbr_ids, 0)) & valid
    new = valid & ~seen & (nd <= r[:, None])
    if not bitset_exact(corpus_size(points), gs.seen_bits.shape[1]):
        new = first_slot_occurrence(gs.seen_bits, nbr_ids, new)

    pos = gs.res_count[:, None] + torch.cumsum(new, dim=1, dtype=torch.int32) - 1
    write_pos = torch.where(new & (pos < cap), pos, cap)
    res = _append(res, write_pos, _pack(nbr_ids, nd))
    n_new = torch.sum(new, dim=1, dtype=torch.int32)
    # mark every fresh in-range neighbor, cap-dropped ones included (the
    # buffer only grows, so a dropped node could never land later)
    bitset_add(gs.seen_bits, nbr_ids, new)
    e_cnt = torch.where(live, e_cnt, 0)
    gs = dataclasses.replace(
        gs, res_count=torch.clamp(gs.res_count + n_new, max=cap),
        expand_ptr=gs.expand_ptr + e_cnt, rounds=gs.rounds + e_cnt,
        overflow=gs.overflow | (gs.res_count + n_new > cap),
        n_dist=gs.n_dist + nd_inc)
    return gs, res


def _greedy_run(points, graph: Graph, q, r, gs: GreedyState, cap: int,
                stop_at, scfg: SearchConfig, active) -> GreedyState:
    """Advance every lane's greedy continuation until its frontier is empty
    or ``gs.rounds`` reaches ``stop_at`` (an int, or a (Q,) tensor of each
    lane's own stop); inactive lanes stay as they are. ``stop_at`` decides
    only whether a lane steps, never how far, so stopping at round s and
    running on later replays the expansions of one uninterrupted run.
    ``gs.seen_bits`` is updated in place."""
    exact_bits = bitset_exact(corpus_size(points), gs.seen_bits.shape[1])
    E1 = scfg.eff_expand_width == 1
    # E >= 2: the packed buffer holds the results while the loop runs
    res = None if E1 else _pack(gs.res_ids, gs.res_dists)
    trip = 0
    while True:
        with trace.span("walk.sync"):
            live = active & (gs.expand_ptr < gs.res_count) & (gs.rounds < stop_at)
            go = keep_walking(live, trip)
        if not go:
            break
        trip += 1
        trace.count("walk.greedy_iters")
        with trace.span("walk.step"):
            if E1:
                gs = _greedy_step_reference(points, graph, q, r, cap, scfg, gs,
                                            exact_bits, live)
            else:
                gs, res = _greedy_step(points, graph, q, r, cap, scfg, gs, res, live)
    if res is not None:
        ids, dists = _unpack(res)
        gs = dataclasses.replace(gs, res_ids=ids, res_dists=dists)
    return gs


def greedy_search(points, graph: Graph, q, r, st: BeamState, cap: int,
                  rounds: int, scfg: SearchConfig, active=None) -> GreedyState:
    """Paper Alg. 2 from finished beam states, every lane at its own radius
    ``r`` (Q,). ``active=False`` lanes do not expand. ``rounds`` is an
    expansion budget; the last iteration may overshoot it by up to E - 1."""
    n_corpus = corpus_size(points)
    num_words = bitset_num_words(n_corpus, scfg.bitset_cap_bits)
    exact_bits = bitset_exact(n_corpus, num_words)
    if active is None:
        active = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    gs = _greedy_init(st, r, cap, num_words, exact_bits)
    gs = _greedy_run(points, graph, q, r, gs, cap, rounds, scfg, active)
    return dataclasses.replace(gs, overflow=gs.overflow | (gs.expand_ptr < gs.res_count))


# ---------------------------------------------------------------------------
# Checkpoint/resume greedy API (continuous-batching serving)
# ---------------------------------------------------------------------------
#
# A ``GreedyState`` is a complete checkpoint of a lane's phase 2: the result
# buffer, expansion pointer, round counter and membership bitset determine
# every later expansion. A serving scheduler seeds checkpoints from phase 1
# and advances them ``slice_rounds`` expansions at a time, rotating finished
# lanes out while stragglers keep their state.

def greedy_seed_batch(corpus, st: BeamState, r, cap: int,
                      scfg: SearchConfig) -> GreedyState:
    """Phase-2 checkpoints for a batch of finished beam states, each lane at
    its own radius ``r`` (scalar or (Q,)): what ``greedy_search`` starts
    from. Advance them with ``greedy_resume_batch``."""
    points = hot_arm(corpus)
    n_corpus = corpus_size(points)
    num_words = bitset_num_words(n_corpus, scfg.bitset_cap_bits)
    rj = broadcast_radius(r, st.ids.shape[0], device=st.ids.device)
    return _greedy_init(st, rj, cap, num_words, bitset_exact(n_corpus, num_words))


def greedy_resume_batch(corpus, graph: Graph, queries, r, gs: GreedyState,
                        active, cap: int, rounds: int, slice_rounds: int,
                        scfg: SearchConfig) -> GreedyState:
    """Advance checkpointed greedy lanes by up to ``slice_rounds`` expansions
    each. A lane stops early when its frontier empties or its lifetime budget
    ``rounds`` is spent; ``active`` (Q,) masks lanes to no-ops. Returns a new
    state and leaves ``gs`` as it was (its bitset is copied before the run
    marks it), so N resumes compose to exactly one ``greedy_search``. The
    end-of-budget overflow bit is not set here (a paused lane has not
    overflowed): ``greedy_lane_done`` gives it at retirement."""
    points = hot_arm(corpus)
    dev = points.device
    queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    rj = broadcast_radius(r, queries.shape[0], device=dev)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    gs = dataclasses.replace(gs, seen_bits=gs.seen_bits.clone())
    stop_at = torch.clamp(gs.rounds + slice_rounds, max=rounds)
    return _greedy_run(points, graph, queries, rj, gs, cap, stop_at, scfg, active)


def greedy_lane_done(gs: GreedyState, rounds: int):
    """Host-side retirement test for resumed lanes: ``(done, overflow)``
    bool numpy arrays (one device-to-host copy). A lane is done when its
    frontier is exhausted or its budget spent; ``overflow`` adds
    ``greedy_search``'s end-of-run ``expand_ptr < res_count`` bit, so a
    sliced lane retires with the one-shot path's flags."""
    ptr, cnt, rds, over = torch.stack(
        [gs.expand_ptr, gs.res_count, gs.rounds,
         gs.overflow.to(torch.int32)]).cpu().numpy()
    done = (ptr >= cnt) | (rds >= rounds)
    return done, over.astype(bool) | (done & (ptr < cnt))


def greedy_coverage(gs: GreedyState) -> np.ndarray:
    """Visited-frontier fraction of each lane, ``expand_ptr / res_count``
    clamped to [0, 1] (1.0 for a lane with no result), as host float64: the
    coverage a deadline-truncated response carries (one device-to-host
    copy)."""
    ptr, cnt = torch.stack([gs.expand_ptr, gs.res_count]).cpu().numpy().astype(np.float64)
    return np.where(cnt > 0, np.minimum(ptr / np.maximum(cnt, 1.0), 1.0), 1.0)


# ---------------------------------------------------------------------------
# Result extraction
# ---------------------------------------------------------------------------

def _beam_results(st: BeamState, r, cap: int):
    """Paper baseline/doubling answer: in-range entries of the active beam."""
    pos = torch.arange(st.ids.shape[1], device=r.device)
    ok = ((st.dists <= r[:, None]) & (st.ids != INVALID_ID)
          & (pos[None] < st.active_width[:, None]))
    dists, ids = _sort_by_dist(torch.where(ok, st.dists, torch.inf),
                               torch.where(ok, st.ids, INVALID_ID))
    qn, dev = ids.shape[0], ids.device
    k = min(cap, ids.shape[1])
    out_ids = torch.full((qn, cap), INVALID_ID, dtype=torch.int32, device=dev)
    out_ids[:, :k] = ids[:, :k]
    out_dists = torch.full((qn, cap), torch.inf, device=dev)
    out_dists[:, :k] = dists[:, :k]
    n_ok = torch.sum(ok, dim=1, dtype=torch.int32)
    return out_ids, out_dists, torch.clamp(n_ok, max=cap), n_ok > cap


def _needs_phase2(st: BeamState, r, lam: float) -> torch.Tensor:
    """Paper Alg. 6 trigger: the size-b beam is λ-saturated with results."""
    thresh = torch.ceil(lam * st.active_width.float()).to(torch.int32)
    return in_range_count(st, r) >= torch.clamp(thresh, min=1)


def _result(st: BeamState, r, cap: int, phase2=None) -> RangeResult:
    ids, dists, count, over = _beam_results(st, r, cap)
    return RangeResult(ids=ids, dists=dists, count=count, overflow=over,
                       n_visited=st.n_visited, n_dist=st.n_dist,
                       es_stopped=st.es_stopped,
                       phase2=torch.zeros_like(st.done) if phase2 is None else phase2,
                       n_rerank=torch.zeros_like(st.n_visited))


def range_phase1(corpus, graph: Graph, queries, start_ids, r, cfg: RangeConfig,
                 es_radius=None):
    """Phase 1 for a batch: ``(beam_state, beam_result, needs_phase2)``."""
    points = hot_arm(corpus)
    rj = broadcast_radius(r, queries.shape[0], device=points.device)
    st = beam_search_batch(points, graph, queries, start_ids, rj, cfg.search,
                           es_radius)
    need = (_needs_phase2(st, rj, cfg.lam) if cfg.mode == "greedy"
            else torch.zeros_like(st.done))
    return st, _result(st, rj, cfg.result_cap), need


# ---------------------------------------------------------------------------
# Result-stage drops: tombstones (live indices) and label predicates
# ---------------------------------------------------------------------------
#
# Both follow one template: a dropped point keeps its vector and edges, so
# the walk routes through it unchanged; only the result buffer loses it
# (stable left-compaction) and the count is recomputed. ``overflow`` is left
# as it is: the buffer pressure happened during the search.

def _compact_kept(keep: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor):
    """Stable left-compaction of the kept slots of each lane's buffer."""
    k = ids.shape[1]
    pos = torch.cumsum(keep, dim=1, dtype=torch.int32) - 1
    wp = torch.where(keep, pos, k)
    out_ids = _append(torch.full_like(ids, INVALID_ID), wp, ids)
    out_d = _append(torch.full_like(dists, torch.inf), wp, dists)
    return out_ids, out_d, torch.sum(keep, dim=1, dtype=torch.int32)


def _as_words(words, device) -> torch.Tensor:
    """A packed bitset (uint32 numpy or an int32 tensor) as int32 words."""
    if not isinstance(words, torch.Tensor):
        words = torch.from_numpy(np.array(words).view(np.int32))
    return words.to(device=device, dtype=torch.int32)


def filter_tombstoned(tombstones, res: RangeResult) -> RangeResult:
    """Remove tombstoned ids from a batched ``RangeResult`` and recount.
    ``tombstones`` must be an exact bitset over corpus slots."""
    tomb = _as_words(tombstones, res.ids.device)
    valid = res.ids != INVALID_ID
    dead = bitset_contains(tomb, torch.where(valid, res.ids, 0)) & valid
    ids, dists, count = _compact_kept(valid & ~dead, res.ids, res.dists)
    return dataclasses.replace(res, ids=ids, dists=dists, count=count)


def filter_labeled(labels, filt: LabelFilter, res: RangeResult) -> RangeResult:
    """Drop results failing each lane's label predicate and recount.
    ``labels`` are the (N, W) packed label rows (``core.labels``), ``filt``
    the batched predicate."""
    dev = res.ids.device
    labels, filt = as_label_rows(labels, dev), filt.to(dev)
    valid = res.ids != INVALID_ID
    rows = labels[torch.where(valid, res.ids, 0).long()]           # (Q, K, W)
    keep = valid & labels_match(rows, filt.masks[:, None, :], filt.is_and[:, None])
    ids, dists, count = _compact_kept(keep, res.ids, res.dists)
    return dataclasses.replace(res, ids=ids, dists=dists, count=count)


# ---------------------------------------------------------------------------
# Exact pair distances and the int8 guard-band rerank
# ---------------------------------------------------------------------------
#
# An int8 corpus searches on certified lower bounds (core.corpus), so the
# loop's plain ``dist <= r`` tests keep a per-candidate superset at the
# caller's radius. Here each kept candidate's upper bound is recovered:
# ``ub <= r`` proves membership, the rest (the ambiguous band) get their
# exact f32 distance from the raw rows and the exact test.

def _tier_of(points):
    """The ``TieredCorpus``, if ``points`` is one (duck typed on the
    ``is_tiered`` marker: core never imports ``tier``)."""
    return points if getattr(points, "is_tiered", False) else None


def exact_pair_dists(raw, queries, ids, lanes, metric: str,
                     use_kernel: bool = True) -> torch.Tensor:
    """(P,) exact f32 distances between raw[ids[p]] and queries[lanes[p]]:
    one rerank_fetch launch on f32 rows; rows stored in another dtype are
    gathered and widened first (the kernel reads f32)."""
    ids = ids.to(torch.int32).contiguous()
    lanes = lanes.to(torch.int32).contiguous()
    if raw.dtype != torch.float32:
        raw = raw[ids.long()].float().contiguous()
        ids = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    return fetch_rerank_pairs(raw, queries, ids, lanes, metric=metric,
                              use_kernel=use_kernel)


def _exact_pairs_for(points, queries, ids_p, lanes_p, metric: str,
                     use_kernel: bool = True) -> torch.Tensor:
    """Exact f32 pair distances for any corpus that holds exact rows: the
    resident rows through ``exact_pair_dists``; a tiered corpus plans and
    fetches its host rows (``TieredCorpus.exact_pairs``, the same kernel on
    the same pairs, so the same bits)."""
    tier = _tier_of(points)
    if tier is not None:
        return tier.exact_pairs(queries, ids_p, lanes_p, metric,
                                use_kernel=use_kernel)
    return exact_pair_dists(corpus_raw(points), queries, ids_p, lanes_p, metric,
                            use_kernel)


def _rerank_band(points, queries, rj, res: RangeResult,
                 cfg: RangeConfig) -> RangeResult:
    """The guard-band rerank of both paths (the reference's
    ``_maybe_rerank_host``, and its fused ``_rerank_fused``, which needs a
    static shape under jit). The ambiguous band is collected as flat
    (lane, slot) pairs across the batch, so the exact pass is one
    rerank_fetch launch whose size is the band's population; a batch with
    an empty band launches nothing. ``ub > r`` marks the band, a band entry
    is kept when its exact distance is within r and then takes it,
    survivors are stably compacted to the left, and ``n_rerank`` and
    ``n_dist`` grow by the band size. A tiered corpus serves the band's
    rows from its host store."""
    tier = _tier_of(points)
    qc = hot_arm(points)
    if not (isinstance(qc, QuantizedCorpus) and cfg.rerank
            and (tier is not None or qc.raw is not None)):
        return res
    with trace.span("result.rerank"):
        return _rerank_pairs(points, qc, queries, rj, res, cfg)


def _rerank_pairs(points, qc: QuantizedCorpus, queries, rj, res: RangeResult,
                  cfg: RangeConfig) -> RangeResult:
    metric = cfg.search.metric
    ids, dists = res.ids, res.dists
    valid = ids != INVALID_ID
    ub = upper_bound_dists(qc, torch.where(valid, ids, 0), dists, queries,
                           metric)
    amb = valid & (ub > rj[:, None])
    lanes_p, slots_p = torch.nonzero(amb, as_tuple=True)  # syncs on the band
    trace.count("host_syncs")
    if lanes_p.numel() == 0:
        return res
    exact = torch.full_like(dists, torch.inf)
    exact[lanes_p, slots_p] = _exact_pairs_for(
        points, queries, ids[lanes_p, slots_p], lanes_p, metric,
        cfg.search.use_kernels)
    keep = valid & torch.where(amb, exact <= rj[:, None], True)
    new_d = torch.where(amb & keep, exact, dists)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    n_rerank = torch.sum(amb, dim=1, dtype=torch.int32)
    return dataclasses.replace(
        res,
        ids=torch.gather(torch.where(keep, ids, INVALID_ID), 1, order),
        dists=torch.gather(torch.where(keep, new_d, torch.inf), 1, order),
        count=torch.sum(keep, dim=1, dtype=torch.int32),
        n_dist=res.n_dist + n_rerank,
        n_rerank=res.n_rerank + n_rerank)


def finalize_results(corpus, queries, r, res: RangeResult, cfg: RangeConfig,
                     tombstones=None, labels=None,
                     label_filter: Optional[LabelFilter] = None) -> RangeResult:
    """Result-stage post-processing of both paths, in the reference's
    order: the tombstone drop, the label drop, then the int8 guard-band
    rerank, so the exact pass never spends gathers on candidates the
    filters already removed. ``r`` is the (Q,) radius."""
    if tombstones is not None:
        res = filter_tombstoned(tombstones, res)
    if labels is not None and label_filter is not None:
        res = filter_labeled(labels, label_filter, res)
    return _rerank_band(corpus, queries, r, res, cfg)


# ---------------------------------------------------------------------------
# Fused batch: phase 2 masked over every lane
# ---------------------------------------------------------------------------

def _range_search_fused(corpus, graph: Graph, queries, start_ids, r,
                        cfg: RangeConfig, es_radius=None, tombstones=None,
                        labels=None, label_filter=None) -> RangeResult:
    points = hot_arm(corpus)
    r = broadcast_radius(r, queries.shape[0], device=points.device)
    queries = queries.to(device=points.device, dtype=torch.float32).contiguous()
    with trace.span("range.phase1"):
        st = beam_search_batch(points, graph, queries, start_ids, r, cfg.search,
                               es_radius)
        if cfg.mode in ("beam", "doubling"):
            phase2 = (st.active_width > cfg.search.beam if cfg.mode == "doubling"
                      else None)
            res = _result(st, r, cfg.result_cap, phase2)
    if cfg.mode == "greedy":
        with trace.span("range.select"):
            active = _needs_phase2(st, r, cfg.lam)
        with trace.span("range.phase2"):
            gs = greedy_search(points, graph, queries, r, st, cfg.result_cap,
                               cfg.frontier_rounds, cfg.search, active)
            base = _result(st, r, cfg.result_cap, active)
            a2 = active[:, None]
            res = dataclasses.replace(
                base,
                ids=torch.where(a2, gs.res_ids, base.ids),
                dists=torch.where(a2, gs.res_dists, base.dists),
                count=torch.where(active, gs.res_count, base.count),
                overflow=torch.where(active, gs.overflow, base.overflow),
                n_dist=st.n_dist + torch.where(active, gs.n_dist, 0))
    with trace.span("range.result"):
        return finalize_results(corpus, queries, r, res, cfg, tombstones, labels,
                                label_filter)


# ---------------------------------------------------------------------------
# Two-phase path with host-side query compaction (the QPS path)
# ---------------------------------------------------------------------------

def _walk_compacted(corpus, graph: Graph, queries, start_ids, r,
                    cfg: RangeConfig, es_radius=None, tombstones=None,
                    labels=None, label_filter=None) -> RangeResult:
    # a tiered corpus walks on its device arm; only the rerank sees the tier
    points = hot_arm(corpus)
    dev = points.device
    queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    rj = broadcast_radius(r, queries.shape[0], device=dev)
    esj = None if es_radius is None else broadcast_radius(
        es_radius, queries.shape[0], device=dev)

    def finish(res: RangeResult) -> RangeResult:
        with trace.span("range.result"):
            return finalize_results(corpus, queries, rj, res, cfg, tombstones,
                                    labels, label_filter)

    # phase 1 runs at the BASE beam for every mode; doubling restarts only
    # its survivors with widening enabled (paper Alg. 5)
    p1_search = cfg.search if cfg.mode != "doubling" else dataclasses.replace(
        cfg.search, max_beam=cfg.search.beam,
        visit_cap=min(cfg.search.visit_cap, 4 * cfg.search.beam))
    with trace.span("range.phase1"):
        st = beam_search_batch(points, graph, queries, start_ids, rj, p1_search, esj)
        base = _result(st, rj, cfg.result_cap)
    if cfg.mode == "beam":
        return finish(base)

    with trace.span("range.select"):
        active = _needs_phase2(st, rj, cfg.lam)
        sel = torch.nonzero(active).flatten()   # syncs on the survivors' count
        trace.count("host_syncs")
    if sel.numel() == 0:
        return finish(base)
    with trace.span("range.phase2"):
        # The reference pads the survivors to a power of two to bound its jit
        # variants; eager PyTorch needs no padding and the lanes are independent.
        sub_q, sub_r = queries[sel], rj[sel]
        if cfg.mode == "doubling":
            sub_starts = start_ids if start_ids.dim() == 1 else start_ids[sel]
            st2 = beam_search_batch(points, graph, sub_q, sub_starts, sub_r,
                                    cfg.search, None if esj is None else esj[sel])
            ids, dists, count, over = _beam_results(st2, sub_r, cfg.result_cap)
            nd = st2.n_dist
        else:
            gs = greedy_search(points, graph, sub_q, sub_r, st.select(sel),
                               cfg.result_cap, cfg.frontier_rounds, cfg.search)
            ids, dists, count, over, nd = (gs.res_ids, gs.res_dists, gs.res_count,
                                           gs.overflow, gs.n_dist)
        merged = dataclasses.replace(
            base,
            ids=base.ids.index_copy(0, sel, ids),
            dists=base.dists.index_copy(0, sel, dists),
            count=base.count.index_copy(0, sel, count),
            overflow=base.overflow.index_copy(0, sel, over),
            n_dist=base.n_dist.index_add(0, sel, nd),
            phase2=active)
    return finish(merged)


# Below this fraction of the corpus, a filtered walk lane gets its default
# entry points augmented with members of its own posting list (the beam
# then starts inside the predicate's region instead of routing to it).
# Lanes at or above it keep the shared defaults untouched, so broad and
# all-pass predicates stay bitwise identical to the unfiltered program.
ENTRY_SEED_FRAC = 0.25


class _Postings:
    """Each lane's posting list (the corpus ids its predicate matches, in
    ascending order), computed once a distinct predicate: lanes that share
    a predicate share its list, count, seeds and fallback decision. The
    reference builds a host (Q, N) match matrix (4 GB at 4096 x 1M); this
    keeps one (G, N) block of the G distinct predicates at a time."""

    def __init__(self, labels: torch.Tensor, filt: LabelFilter):
        key = torch.cat([filt.masks, filt.is_and[:, None].to(torch.int32)], 1)
        uniq, inv = torch.unique(key, dim=0, return_inverse=True)
        self.labels = labels
        self.groups = LabelFilter(masks=uniq[:, :-1].contiguous(),
                                  is_and=uniq[:, -1].bool())
        self.group = inv.cpu().numpy()                                  # (Q,)
        self.counts = label_match_counts(labels, self.groups).cpu().numpy()[self.group]
        self._lists: dict = {}

    def of_lane(self, lane: int) -> torch.Tensor:
        g = int(self.group[lane])
        if g not in self._lists:
            m = labels_match(self.labels, self.groups.masks[g], self.groups.is_and[g])
            self._lists[g] = torch.nonzero(m).flatten().to(torch.int32)
        return self._lists[g]


def _fallback_scan(points, queries, rj, tombstones, postings: _Postings,
                   fb_sel: np.ndarray, cap: int, metric: str,
                   use_kernel: bool = True):
    """Exact scan of each fallback lane's posting list. ``points`` is any
    corpus that holds exact rows (an f32/bf16 tensor, a quantized corpus
    with raw rows, or a tiered corpus). Tombstoned ids are dropped first;
    every lane's pairs go through one ``_exact_pairs_for`` call (the same
    rerank_fetch path as the guard band), and each lane keeps its ``d <= r``
    pairs in ascending distance, ties to the lower id: the post-filtered
    oracle's answer by construction. Returns (ids, dists, count, overflow,
    n_dist) of the ``fb_sel`` lanes."""
    dev = queries.device
    m = len(fb_sel)
    per = [postings.of_lane(int(lane)) for lane in fb_sel]
    ids_p = torch.cat(per) if per else torch.zeros(0, dtype=torch.int32, device=dev)
    local = torch.repeat_interleave(
        torch.arange(m, device=dev),
        torch.tensor([p.numel() for p in per], dtype=torch.long, device=dev))
    if tombstones is not None and ids_p.numel():
        live = ~bitset_contains(_as_words(tombstones, dev), ids_p)
        ids_p, local = ids_p[live], local[live]
    ndist = torch.bincount(local, minlength=m).to(torch.int32)
    out_ids = torch.full((m, cap), INVALID_ID, dtype=torch.int32, device=dev)
    out_d = torch.full((m, cap), torch.inf, device=dev)
    lanes = torch.as_tensor(fb_sel, dtype=torch.long, device=dev)
    if ids_p.numel() == 0:
        zero = torch.zeros(m, dtype=torch.int32, device=dev)
        return out_ids, out_d, zero, zero.bool(), ndist
    d = _exact_pairs_for(points, queries, ids_p, lanes[local], metric, use_kernel)
    keep = d <= rj[lanes][local]
    kid, kd, kl = ids_p[keep], d[keep], local[keep]
    # by lane, then ascending distance, then id (the lists are ascending);
    # + 0.0 makes -0.0 equal to 0.0, as the reference's numpy sort has it
    order = torch.sort(kd + 0.0, stable=True).indices
    order = order[torch.sort(kl[order], stable=True).indices]
    kid, kd, kl = kid[order], kd[order], kl[order]
    kept = torch.bincount(kl, minlength=m)
    pos = torch.arange(kl.numel(), device=dev) - (torch.cumsum(kept, 0) - kept)[kl]
    fit = pos < cap
    out_ids[kl[fit], pos[fit]] = kid[fit]
    out_d[kl[fit], pos[fit]] = kd[fit]
    return (out_ids, out_d, torch.clamp(kept, max=cap).to(torch.int32),
            kept > cap, ndist)


def _range_search_compacted(corpus, graph: Graph, queries, start_ids, r,
                            cfg: RangeConfig, es_radius=None, tombstones=None,
                            labels=None, label_filter=None) -> RangeResult:
    """Compacted-path front door: per-lane selectivity dispatch. A filtered
    batch first counts each lane's posting list: lanes below
    ``cfg.filter_threshold`` of the corpus skip the graph and scan their
    list exactly (``_fallback_scan``); walk lanes below ``ENTRY_SEED_FRAC``
    start from the default entry points plus an evenly spaced sample of
    their list; one batch mixes both paths. The fallback needs exact rows
    (an int8 corpus without raw rows walks every lane)."""
    if labels is None or label_filter is None:
        return _walk_compacted(corpus, graph, queries, start_ids, r, cfg,
                               es_radius, tombstones)
    points = hot_arm(corpus)
    dev = points.device
    queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    n_q = queries.shape[0]
    rj = broadcast_radius(r, n_q, device=dev)
    esj = None if es_radius is None else broadcast_radius(es_radius, n_q, device=dev)
    labels, label_filter = as_label_rows(labels, dev), label_filter.to(dev)
    n_corpus = corpus_size(points)
    postings = _Postings(labels, label_filter)
    counts = postings.counts
    has_exact = (_tier_of(corpus) is not None
                 or not isinstance(points, QuantizedCorpus) or points.raw is not None)
    fb = (counts < cfg.filter_threshold * n_corpus
          if cfg.filter_threshold > 0.0 and has_exact else np.zeros(n_q, bool))

    # filter-aware entry points: selective walk lanes also start from an
    # evenly spaced sample of their list (INVALID padding and init_state's
    # duplicate collapse keep unseeded lanes equal to the shared starts)
    seed = ~fb & (counts > 0) & (counts < ENTRY_SEED_FRAC * n_corpus)
    walk_starts = start_ids
    if seed.any():
        s0 = start_ids.to(device=dev, dtype=torch.int32)
        n_seed = s0.shape[-1]
        walk_starts = torch.cat(
            [s0.expand(n_q, n_seed),
             torch.full((n_q, n_seed), INVALID_ID, dtype=torch.int32, device=dev)], 1)
        for lane in np.nonzero(seed)[0]:
            pid = postings.of_lane(int(lane))
            pick = np.linspace(0, pid.numel() - 1,
                               min(n_seed, pid.numel())).astype(np.int64)
            walk_starts[lane, n_seed:n_seed + pick.size] = pid[torch.from_numpy(pick).to(dev)]

    if not fb.any():
        return _walk_compacted(corpus, graph, queries, walk_starts, rj, cfg, esj,
                               tombstones, labels, label_filter)

    cap = cfg.result_cap
    fb_sel, w_sel = np.nonzero(fb)[0], np.nonzero(~fb)[0]
    f_ids, f_d, f_cnt, f_over, f_nd = _fallback_scan(
        corpus, queries, rj, tombstones, postings, fb_sel, cap,
        cfg.search.metric, cfg.search.use_kernels)
    zi = torch.zeros(n_q, dtype=torch.int32, device=dev)
    out = RangeResult(
        ids=torch.full((n_q, cap), INVALID_ID, dtype=torch.int32, device=dev),
        dists=torch.full((n_q, cap), torch.inf, device=dev),
        count=zi, overflow=zi.bool(), n_visited=zi.clone(), n_dist=zi.clone(),
        es_stopped=zi.bool(), phase2=zi.bool(), n_rerank=zi.clone())
    fb_t = torch.from_numpy(fb_sel).to(dev)
    out.ids[fb_t], out.dists[fb_t], out.count[fb_t] = f_ids, f_d, f_cnt
    out.overflow[fb_t], out.n_dist[fb_t] = f_over, f_nd
    if w_sel.size:
        w_t = torch.from_numpy(w_sel).to(dev)
        wres = _walk_compacted(
            corpus, graph, queries[w_t],
            walk_starts if walk_starts.dim() == 1 else walk_starts[w_t],
            rj[w_t], cfg, None if esj is None else esj[w_t], tombstones, labels,
            label_filter.select(w_t))
        for f in dataclasses.fields(RangeResult):
            getattr(out, f.name)[w_t] = getattr(wres, f.name)
    return out


# ---------------------------------------------------------------------------
# Public entry points — keyword-only, the reference's parameter order
# ---------------------------------------------------------------------------

def _check_corpus(corpus):
    points = hot_arm(corpus)
    if isinstance(points, QuantizedCorpus):
        return
    if not isinstance(points, torch.Tensor) or points.dtype not in (
            torch.float32, torch.bfloat16):
        raise NotImplementedError(
            "a corpus other than an f32/bf16 tensor, a QuantizedCorpus or a "
            "TieredCorpus over one")


def range_search_fused(*, corpus, graph, queries, start_ids, r, cfg,
                       es_radius=None, tombstones=None, labels=None,
                       label_filter=None) -> RangeResult:
    """Batched range search with phase 2 masked (not compacted) over every
    lane, then the result stage (tombstones, labels, then the int8
    guard-band rerank). ``r``/``es_radius`` are a scalar or per-query
    ``(Q,)`` radii; ``labels``/``label_filter`` the (N, W) packed label rows
    and the batched predicate. The fused path always walks: the
    selectivity fallback lives on the compacted path."""
    _check_corpus(corpus)
    return _range_search_fused(corpus, graph, queries, start_ids, r, cfg,
                               es_radius, tombstones, labels, label_filter)


def range_search_compacted(*, corpus, graph, queries, start_ids, r, cfg,
                           es_radius=None, tombstones=None, labels=None,
                           label_filter=None) -> RangeResult:
    """Two-phase batched range search (the QPS path): phase 1 over the
    whole batch, phase 2 over the survivor lanes only, each at its own
    radius, then the result stage (tombstones, labels, then the int8
    guard-band rerank). With ``labels``/``label_filter``, lanes whose
    predicate matches fewer than ``cfg.filter_threshold`` of the corpus
    scan their posting list instead of walking, and selective walk lanes
    get entry points inside their list."""
    _check_corpus(corpus)
    return _range_search_compacted(corpus, graph, queries, start_ids, r, cfg,
                                   es_radius, tombstones, labels, label_filter)
