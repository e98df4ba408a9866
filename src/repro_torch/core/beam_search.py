"""Batched graph beam search with range-retrieval extensions.

The paper's Algorithms 1 (BeamSearch), 3/4 (EarlyStopping) and 5
(DoublingSearch), as one loop over a batch of Q lanes:

* the beam is a distance-sorted triple ``(ids, dists, expanded)`` of length
  ``max_beam``, of which the first ``active_width`` entries (the paper's
  beam size ``b``) are eligible for expansion;
* every iteration expands the closest ``expand_width`` (E) unexpanded beam
  entries of every lane at once through the fused expand kernel
  (``kernels.expand``); E == 1 runs the paper-faithful single-node step;
* a per-lane bitset (``core.bitset``) marks every node when it first enters
  the beam, so "seen?" is one bit probe per candidate;
* the candidate tile merges into the sorted beam by a stable sort of
  int-keyed distances: the same permutation as the reference's rank-gather
  (the beam, first in concatenation order, wins ties);
* doubling widens ``b`` in place when the active prefix is fully expanded
  and at least ``lam * b`` of it is in range;
* every expansion is appended to a visited log (``visit_cap`` entries, a
  strict expansion budget).

The reference runs each lane in a vmapped ``while_loop`` in which a finished
lane stays frozen. Here one loop steps every lane and freezes finished ones
with ``torch.where(done, old, new)``; a frozen lane hands the kernel an
all-INVALID frontier, so nothing is gathered for it. The loop ends when the
host sees every lane done (one device-to-host sync per iteration).
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Optional

import torch

from .. import trace
from ..kernels.expand import expand_frontier
from ..utils import INVALID_ID
from .bitset import (
    DEFAULT_BITSET_CAP_BITS,
    bitset_add,
    bitset_contains,
    bitset_exact,
    bitset_init,
    bitset_num_words,
    first_slot_occurrence,
)
from .corpus import CORPUS_DTYPES, corpus_size
from .distances import gather_dist
from .graph import Graph

# Early-stop metric selector (paper Sec. 4.3).
ES_NONE = 0
ES_D_VISITED = 1   # distance to the node being visited (paper's best)
ES_D_TOP1 = 2      # distance to closest known neighbor
ES_D_TOP10 = 3     # distance to 10th closest known neighbor
ES_RATIO_TOP10 = 4 # d_top10 / d_start


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Search hyper-parameters."""

    beam: int = 64            # initial beam width b (paper's B)
    max_beam: int = 64        # allocation; > beam enables in-place doubling
    visit_cap: int = 256      # max expansions == visited-log capacity
    lam: float = 1.0          # λ: in-range fraction of beam that triggers widening
    es_metric: int = ES_NONE  # early-stopping metric (ES_*)
    es_visit_limit: int = 20  # vl: expansions before early stop may trigger
    metric: str = "l2"
    expand_width: int = 4     # E: frontier nodes expanded per iteration
    bitset_cap_bits: int = DEFAULT_BITSET_CAP_BITS  # seen-filter memory bound
    # On an int8 corpus, the expansion's arithmetic: False is the f32-query
    # form (the reference's XLA path and default), True the int8-query form
    # of the reference's Pallas kernel (quantized query, exact int8 dot),
    # which the TPU deployment runs. gather_dist always takes the f32-query
    # form. On an f32/bf16 corpus it changes nothing: that kernel computes
    # the diff form either way.
    use_expand_kernel: bool = False
    # CUDA kernels (expand, gatherdist, rerank_fetch) on a CUDA corpus;
    # False runs their plain PyTorch versions on the same device, for checks
    # and timing
    use_kernels: bool = True
    # declared corpus storage dtype: "float32" | "bfloat16" | "int8". The
    # search dispatches on the corpus value (tensor or QuantizedCorpus); this
    # is what deploy configs and engine constructors consult to make the corpus
    corpus_dtype: str = "float32"

    def __post_init__(self):
        if self.beam < 1 or self.max_beam < self.beam:
            raise ValueError("need 1 <= beam <= max_beam")
        if self.visit_cap < 1:
            raise ValueError("visit_cap must be >= 1")
        if self.expand_width < 1:
            raise ValueError("expand_width must be >= 1")
        if self.bitset_cap_bits < 32:
            raise ValueError("bitset_cap_bits must be >= 32")
        if self.corpus_dtype not in CORPUS_DTYPES:
            raise ValueError(f"corpus_dtype must be one of {CORPUS_DTYPES}")

    @property
    def eff_expand_width(self) -> int:
        """E clamped to the beam allocation."""
        return min(self.expand_width, self.max_beam)


@dataclasses.dataclass
class BeamState:
    """Per-lane search state; every field has a leading (Q,) lane axis."""

    ids: torch.Tensor        # (Q, L) int32, distance-sorted, INVALID_ID padded
    dists: torch.Tensor      # (Q, L) float32, +inf padded
    expanded: torch.Tensor   # (Q, L) bool
    active_width: torch.Tensor  # (Q,) int32 — the paper's b
    n_visited: torch.Tensor  # (Q,) int32
    d_visited: torch.Tensor  # (Q,) float32 — farthest node expanded last step
    d_start: torch.Tensor    # (Q,) float32 — distance to the search entry point
    visited_ids: torch.Tensor    # (Q, V) int32 log of expanded nodes
    visited_dists: torch.Tensor  # (Q, V) float32
    visited_bits: torch.Tensor   # (Q, W) int32 — discovered-node bitset
    n_dist: torch.Tensor     # (Q,) int32 distance-computation counter
    es_stopped: torch.Tensor # (Q,) bool — terminated by early stopping
    done: torch.Tensor       # (Q,) bool

    def select(self, lanes: torch.Tensor) -> "BeamState":
        """The state of the given lanes (an index tensor)."""
        return BeamState(**{f.name: getattr(self, f.name)[lanes]
                            for f in dataclasses.fields(self)})


def _where_state(cond: torch.Tensor, a: BeamState, b: BeamState) -> BeamState:
    """Lane-wise ``where(cond, a, b)`` over every field but the bitset,
    which the steps update in place for the expanding lanes only (a copy
    per iteration would move 512 MiB at Q=4096, N=1M)."""
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "visited_bits":
            out[f.name] = x
        else:
            out[f.name] = torch.where(cond.view(-1, *([1] * (x.dim() - 1))), x, y)
    return BeamState(**out)


def _f32_ascending_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone re-encoding of f32 as the reference's uint32 key, held in
    int64 (sign-flip trick; handles +-inf, and -0.0 < +0.0 as in a total
    order). PyTorch has no uint32 arithmetic, hence int64."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u ^ 0x80000000)


def _f32_from_key(k: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_f32_ascending_key``."""
    u = torch.where(k >= 0x80000000, k ^ 0x80000000, k ^ 0xFFFFFFFF)
    return u.to(torch.int32).view(torch.float32)  # int64 -> int32 wraps


def _sort_by_dist(dists: torch.Tensor, *others: torch.Tensor):
    """Stable ascending sort of each row by distance (total order, as the
    reference's ``lax.sort``); ``others`` are permuted alike."""
    order = torch.sort(_f32_ascending_key(dists), dim=-1, stable=True).indices
    return (torch.gather(dists, -1, order),
            *(torch.gather(o, -1, order) for o in others))


def _sorted_trunc(ids, dists, expanded, length: int):
    """Sort (dists, ids, expanded) ascending by distance; keep first `length`."""
    dists, ids, expanded = _sort_by_dist(dists, ids, expanded)
    return ids[:, :length], dists[:, :length], expanded[:, :length]


def _merge_sorted(b_ids, b_dists, b_exp, c_ids, c_dists, length: int):
    """Merge the candidate tile into the sorted beam; keep the closest
    ``length``. Returns ``(ids, dists, expanded, entrant)``; ``entrant``
    marks output slots filled from the candidate tile. A stable sort of the
    int keys is the reference's rank permutation (index tiebreak; the beam
    comes first in concatenation order, so it wins ties)."""
    lb = b_ids.shape[1]
    keys = torch.cat([_f32_ascending_key(b_dists), _f32_ascending_key(c_dists)], 1)
    ids = torch.cat([b_ids, c_ids], 1)
    src = torch.sort(keys, dim=1, stable=True).indices[:, :length]
    out_ids = torch.gather(ids, 1, src)
    out_dists = _f32_from_key(torch.gather(keys, 1, src))
    from_beam = src < lb
    out_exp = from_beam & torch.gather(b_exp, 1, torch.clamp(src, max=lb - 1))
    return out_ids, out_dists, out_exp, ~from_beam


def init_state(points, q: torch.Tensor, start_ids: torch.Tensor,
               cfg: SearchConfig) -> BeamState:
    """Seed every lane's beam with the start points (shared (S,) or
    per-lane (Q, S)); ``points`` is a tensor or a ``QuantizedCorpus``."""
    qn = q.shape[0]
    dev = q.device
    L, V = cfg.max_beam, cfg.visit_cap
    W = bitset_num_words(corpus_size(points), cfg.bitset_cap_bits)
    s = start_ids.to(device=dev, dtype=torch.int32)
    s = s.expand(qn, -1) if s.dim() == 1 else s
    if s.shape[1] > L:
        raise ValueError(f"{s.shape[1]} start points exceed max_beam={L}")
    sd = gather_dist(points, s, q, cfg.metric, cfg.use_kernels)
    # collapse identical start slots (keep first); in the hashed regime this
    # also collapses colliding buckets, keeping bitset_add exact
    slot = s % (W * 32)
    order = torch.arange(s.shape[1], device=dev)
    dup = (slot[:, :, None] == slot[:, None, :]) & (order[:, None] > order[None, :])
    is_dup = torch.any(dup, dim=2)
    sd = torch.where(is_dup, torch.inf, sd)
    s = torch.where(is_dup, INVALID_ID, s)
    bits = bitset_add(bitset_init(W, qn, dev), s, s != INVALID_ID)

    ids = torch.full((qn, L), INVALID_ID, dtype=torch.int32, device=dev)
    ids[:, :s.shape[1]] = s
    dists = torch.full((qn, L), torch.inf, device=dev)
    dists[:, :s.shape[1]] = sd
    expanded = torch.zeros((qn, L), dtype=torch.bool, device=dev)
    ids, dists, expanded = _sorted_trunc(ids, dists, expanded, L)
    zi = torch.zeros(qn, dtype=torch.int32, device=dev)
    zb = torch.zeros(qn, dtype=torch.bool, device=dev)
    return BeamState(
        ids=ids, dists=dists, expanded=expanded,
        active_width=torch.full_like(zi, cfg.beam),
        n_visited=zi,
        d_visited=torch.zeros(qn, device=dev),
        d_start=torch.min(sd, dim=1).values,
        visited_ids=torch.full((qn, V), INVALID_ID, dtype=torch.int32, device=dev),
        visited_dists=torch.full((qn, V), torch.inf, device=dev),
        visited_bits=bits,
        # only distinct starts are charged (duplicates were dropped above)
        n_dist=torch.sum(s != INVALID_ID, dim=1, dtype=torch.int32),
        es_stopped=zb, done=zb,
    )


def _es_value(st: BeamState, cand_dist, cfg: SearchConfig):
    if cfg.es_metric == ES_D_VISITED:
        return cand_dist
    if cfg.es_metric == ES_D_TOP1:
        return st.dists[:, 0]
    top10 = torch.gather(st.dists, 1,
                         torch.clamp(st.active_width - 1, max=9).long()[:, None])[:, 0]
    if cfg.es_metric == ES_D_TOP10:
        return top10
    if cfg.es_metric == ES_RATIO_TOP10:
        return top10 / torch.clamp(st.d_start, min=1e-30)
    return torch.full_like(cand_dist, torch.inf)


def in_range_count(st: BeamState, r: torch.Tensor,
                   width: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-lane number of in-range entries within the first `width` slots."""
    w = st.active_width if width is None else width
    pos_ok = torch.arange(st.ids.shape[1], device=r.device)[None, :] < w[:, None]
    return torch.sum((st.dists <= r[:, None]) & (st.ids != INVALID_ID) & pos_ok,
                     dim=1, dtype=torch.int32)


def _widen_or_finish(st: BeamState, r, has_frontier, cfg: SearchConfig):
    """Alg. 5: an exhausted frontier at a λ-saturated width doubles ``b``
    (up to ``max_beam``); an exhausted one that cannot widen finishes."""
    thresh = torch.ceil(cfg.lam * st.active_width.float()).to(torch.int32)
    can_widen = (st.active_width < cfg.max_beam) & (in_range_count(st, r) >= thresh)
    new_width = torch.where(~has_frontier & can_widen,
                            torch.clamp(st.active_width * 2, max=cfg.max_beam),
                            st.active_width)
    return new_width, ~has_frontier & ~can_widen


def _es_trigger(st: BeamState, r, es_radius, has_frontier, cand_dist,
                cfg: SearchConfig):
    """Algs. 3/4, on the closest candidate; never once a lane has found an
    in-range candidate."""
    if cfg.es_metric == ES_NONE:
        return torch.zeros_like(has_frontier)
    return (has_frontier & ~(st.dists[:, 0] <= r)
            & (st.n_visited >= cfg.es_visit_limit)
            & (_es_value(st, cand_dist, cfg) > es_radius))


def _keep_state(st, new_width, es_trigger, finished) -> BeamState:
    return dataclasses.replace(st, active_width=new_width,
                               es_stopped=st.es_stopped | es_trigger,
                               done=finished | es_trigger)


def _step_reference(points, graph: Graph, q, r, es_radius, cfg: SearchConfig,
                    st: BeamState, live: torch.Tensor) -> BeamState:
    """The paper-faithful single-node step (``expand_width=1``): unfused
    ``out_neighbors`` + ``gather_dist``, duplicate suppression by three
    broadcast scans (intra-row, beam, visited log) and a full sort over
    ``max_beam + R``. The bitset is carried through untouched."""
    L = cfg.max_beam
    pos = torch.arange(L, device=q.device)
    eligible = (st.ids != INVALID_ID) & ~st.expanded & (pos[None] < st.active_width[:, None])
    has_frontier = torch.any(eligible, dim=1)
    new_width, finished = _widen_or_finish(st, r, has_frontier, cfg)

    idx = torch.argmax(eligible.to(torch.int8), dim=1)  # closest unexpanded
    cand_id = torch.gather(st.ids, 1, idx[:, None])[:, 0]
    cand_dist = torch.gather(st.dists, 1, idx[:, None])[:, 0]
    es_trigger = _es_trigger(st, r, es_radius, has_frontier, cand_dist, cfg)
    do_expand = has_frontier & ~es_trigger

    nbrs = graph.out_neighbors(torch.where(do_expand & live, cand_id, INVALID_ID))
    nd = gather_dist(points, nbrs, q, cfg.metric, cfg.use_kernels)   # (Q, R)
    rr = torch.arange(nbrs.shape[1], device=q.device)
    inv = nbrs[:, :, None] != INVALID_ID
    dup_in_row = torch.any((nbrs[:, :, None] == nbrs[:, None, :])
                           & (rr[None, None, :] < rr[None, :, None]) & inv, dim=2)
    in_beam = torch.any((nbrs[:, :, None] == st.ids[:, None, :]) & inv, dim=2)
    in_visited = torch.any((nbrs[:, :, None] == st.visited_ids[:, None, :]) & inv, dim=2)
    fresh = ~dup_in_row & ~in_beam & ~in_visited
    nd = torch.where(fresh, nd, torch.inf)
    nbr_ids = torch.where(fresh, nbrs, INVALID_ID)

    expanded = st.expanded | (pos[None] == idx[:, None])
    with trace.span("walk.merge"):
        m_ids, m_dists, m_exp = _sorted_trunc(
            torch.cat([st.ids, nbr_ids], 1), torch.cat([st.dists, nd], 1),
            torch.cat([expanded, torch.zeros_like(fresh)], 1), L)

    v_idx = torch.clamp(st.n_visited, max=cfg.visit_cap - 1).long()[:, None]
    exp_state = dataclasses.replace(
        st, ids=m_ids, dists=m_dists, expanded=m_exp, active_width=new_width,
        n_visited=st.n_visited + 1, d_visited=cand_dist,
        visited_ids=st.visited_ids.scatter(1, v_idx, cand_id[:, None]),
        visited_dists=st.visited_dists.scatter(1, v_idx, cand_dist[:, None]),
        n_dist=st.n_dist + torch.sum(nbrs != INVALID_ID, dim=1, dtype=torch.int32),
        done=(st.n_visited + 1) >= cfg.visit_cap)
    keep_state = _keep_state(st, new_width, es_trigger, finished)
    return _where_state(do_expand, exp_state, keep_state)


def _expand_tile(points, graph: Graph, frontier, q, cfg: SearchConfig):
    """Fused expansion of a (Q, E) frontier: (Q, E*R) ids/dists + n_dist.
    On an int8 corpus ``cfg.use_expand_kernel`` picks the int8-query form
    (the reference's Pallas kernel) over the f32-query form (its XLA path);
    ``cfg.use_kernels`` picks the CUDA kernel over its plain version."""
    return expand_frontier(points, graph.neighbors, frontier, q,
                           metric=cfg.metric, use_kernel=cfg.use_kernels,
                           quantize_query=cfg.use_expand_kernel)


def _step(points, graph: Graph, q, r, es_radius, cfg: SearchConfig,
          st: BeamState, live: torch.Tensor) -> BeamState:
    """One iteration for every lane; lanes outside ``live`` get an INVALID
    frontier and leave the bitset untouched (the caller freezes them)."""
    if cfg.eff_expand_width == 1:
        return _step_reference(points, graph, q, r, es_radius, cfg, st, live)
    L, E = cfg.max_beam, cfg.eff_expand_width
    dev = q.device
    pos = torch.arange(L, device=dev)
    eligible = (st.ids != INVALID_ID) & ~st.expanded & (pos[None] < st.active_width[:, None])
    num_elig = torch.sum(eligible, dim=1, dtype=torch.int32)
    has_frontier = num_elig > 0
    new_width, finished = _widen_or_finish(st, r, has_frontier, cfg)

    idx = torch.argmax(eligible.to(torch.int8), dim=1)  # closest unexpanded
    cand0_dist = torch.gather(st.dists, 1, idx[:, None])[:, 0]
    es_trigger = _es_trigger(st, r, es_radius, has_frontier, cand0_dist, cfg)
    do_expand = has_frontier & ~es_trigger

    # -- the closest E unexpanded slots (the beam is sorted) -----------------
    e_cnt = torch.minimum(torch.clamp(num_elig, max=E), cfg.visit_cap - st.n_visited)
    lane = torch.arange(E, device=dev)
    lane_ok = lane[None] < e_cnt[:, None]                             # (Q, E)
    ecum = torch.cumsum(eligible, dim=1, dtype=torch.int32)
    sel_hit = (eligible[:, :, None] & (ecum[:, :, None] == (lane + 1)[None, None])
               & lane_ok[:, None, :])                                 # (Q, L, E)
    sel = torch.argmax(sel_hit.to(torch.int8), dim=1)                 # (Q, E)
    cand_ids = torch.where(lane_ok, torch.gather(st.ids, 1, sel), INVALID_ID)
    cand_dists = torch.where(lane_ok, torch.gather(st.dists, 1, sel), torch.inf)

    # -- fused expansion + bitset seen filter --------------------------------
    go = do_expand & live
    frontier = torch.where(go[:, None], cand_ids, INVALID_ID).contiguous()
    nbr_ids, nd, nd_inc = _expand_tile(points, graph, frontier, q, cfg)
    valid = nbr_ids != INVALID_ID
    seen = bitset_contains(st.visited_bits, torch.where(valid, nbr_ids, 0)) & valid
    fresh = valid & ~seen
    nbr_ids = torch.where(fresh, nbr_ids, INVALID_ID)
    nd = torch.where(fresh, nd, torch.inf)

    # -- merge the candidate tile into the sorted beam -----------------------
    expanded = st.expanded | torch.any(sel_hit, dim=2)
    with trace.span("walk.merge"):
        m_ids, m_dists, m_exp, entrant = _merge_sorted(
            st.ids, st.dists, expanded, nbr_ids, nd, L)

    # -- mark beam entrants in the seen bitset (in place, expanding lanes) ---
    # A node is "seen" once it has held a beam slot; candidates truncated
    # straight off the merge stay unmarked and may be rediscovered.
    mark = entrant & (m_ids != INVALID_ID) & go[:, None]
    if not bitset_exact(corpus_size(points), st.visited_bits.shape[1]):
        mark = first_slot_occurrence(st.visited_bits, m_ids, mark)
    bitset_add(st.visited_bits, m_ids, mark)

    # -- visited log: one append per expanded node ---------------------------
    # (slot visit_cap is a scratch column that takes the skipped lanes)
    v_idx = torch.where(lane_ok, st.n_visited[:, None] + lane, cfg.visit_cap).long()
    pad_i = torch.full_like(cand_ids[:, :1], INVALID_ID)
    pad_d = torch.full_like(cand_dists[:, :1], torch.inf)
    visited_ids = torch.cat([st.visited_ids, pad_i], 1).scatter(
        1, v_idx, cand_ids)[:, :-1]
    visited_dists = torch.cat([st.visited_dists, pad_d], 1).scatter(
        1, v_idx, cand_dists)[:, :-1]

    exp_state = dataclasses.replace(
        st, ids=m_ids, dists=m_dists, expanded=m_exp, active_width=new_width,
        n_visited=st.n_visited + e_cnt,
        d_visited=torch.max(torch.where(lane_ok, cand_dists, -torch.inf), dim=1).values,
        visited_ids=visited_ids, visited_dists=visited_dists,
        n_dist=st.n_dist + nd_inc,
        done=(st.n_visited + e_cnt) >= cfg.visit_cap)
    keep_state = _keep_state(st, new_width, es_trigger, finished)
    return _where_state(do_expand, exp_state, keep_state)


def broadcast_radius(r, n: int, default: float = float("inf"),
                     device="cpu") -> torch.Tensor:
    """Normalize a radius argument to a per-query ``(n,)`` float32 tensor:
    ``None`` (-> ``default``), a scalar, a 0-d array (broadcast), or an
    ``(n,)`` vector."""
    if r is None:
        r = default
    from_host = not isinstance(r, torch.Tensor) or r.device.type == "cpu"
    r = torch.as_tensor(r, dtype=torch.float32, device=device)
    if from_host and r.device.type == "cuda":
        # a copy from pageable host memory waits for the stream to drain
        trace.count("host_syncs")
    if r.dim() == 0:
        return r.expand(n).contiguous()
    if tuple(r.shape) != (n,):
        raise ValueError(f"radius vector has shape {tuple(r.shape)}, expected ({n},)")
    return r


class _Walk(threading.local):
    def __init__(self):
        self.trips = None


_WALK = _Walk()


@contextmanager
def walk_trips(n: int):
    """Within this scope every search loop (the beam walk, the greedy walk)
    runs exactly ``n`` iterations instead of ending on its host test: the
    dry run traces one iteration of a walk, whose ``live.any()`` a fake
    tensor cannot answer."""
    prev, _WALK.trips = _WALK.trips, n
    try:
        yield
    finally:
        _WALK.trips = prev


def keep_walking(live: torch.Tensor, trip: int) -> bool:
    """A search loop's test before its ``trip``-th iteration: whether any
    lane is live (a host sync), or the trip count of ``walk_trips``."""
    if _WALK.trips is not None:
        return trip < _WALK.trips
    trace.count("host_syncs")
    return bool(live.any())


def beam_search(points, graph: Graph, q: torch.Tensor, start_ids: torch.Tensor, r,
                cfg: SearchConfig, es_radius=None) -> BeamState:
    """Run the search loop for one query ``q`` (d,) (``r``/``es_radius`` are
    scalars): a batch of one through ``beam_search_batch``, its lane axis
    dropped from every field."""
    st = beam_search_batch(points, graph, torch.as_tensor(q)[None], start_ids, r, cfg,
                           es_radius)
    return BeamState(**{f.name: getattr(st, f.name)[0] for f in dataclasses.fields(st)})


def beam_search_batch(points, graph: Graph, queries: torch.Tensor,
                      start_ids: torch.Tensor, r, cfg: SearchConfig,
                      es_radius=None) -> BeamState:
    """Batched search over a tensor corpus or a ``QuantizedCorpus`` (which
    searches on certified lower bounds); ``r`` and ``es_radius`` are
    scalars or per-lane (Q,) radii; ``start_ids`` is shared ``(S,)`` or
    per-lane ``(Q, S)``."""
    dev = points.device
    queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    n = queries.shape[0]
    rv = broadcast_radius(r, n, device=dev)
    esv = broadcast_radius(es_radius, n, device=dev)
    st = init_state(points, queries, start_ids, cfg)
    trip = 0
    while True:
        with trace.span("walk.sync"):
            live = ~st.done
            go = keep_walking(live, trip)
        if not go:
            return st
        trip += 1
        trace.count("walk.beam_iters")
        with trace.span("walk.step"):
            new = _step(points, graph, queries, rv, esv, cfg, st, live)
            st = _where_state(live, new, st)


def topk_from_state(st: BeamState, k: int):
    """Top-k (ids, dists) from a finished search (standard ANNS answer)."""
    return st.ids[:, :k], st.dists[:, :k]
