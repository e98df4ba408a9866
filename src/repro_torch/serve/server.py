"""RangeServer: the serving layer around the range engine.

One process serving one engine, as the reference's single-engine path:

* **admission queue**: requests land with an id and an optional deadline;
  the batcher drains up to ``max_batch`` or until ``max_wait_s`` passes.
  Radii are per request: a micro-batch mixes radii freely, each lane
  answered at its own. Admission is bounded: beyond ``max_queue`` pending
  requests ``submit`` sheds (and counts) instead of queueing without limit.
  Malformed requests are rejected at ``submit``.
* **lockstep execution** (default): one ``range_search_compacted`` call a
  micro-batch; the whole batch returns together.
* **continuous batching** (``ServerConfig.continuous``): phase 1 still runs
  per micro-batch, but λ-saturated lanes hand their ``GreedyState``
  checkpoints to a persistent ``LaneScheduler`` pool advanced
  ``slice_rounds`` expansions a step; cheap lanes answer at phase 1 and
  leave at once. An optional ``EffortPredictor`` splits each drain into a
  cheap dispatch and a heavy one (predicted match count against
  ``effort_threshold``); it shapes batch composition only, never results.
* **deadlines** on an injectable clock: a request still queued past its
  budget is shed with ``code="deadline_expired"``; a pooled lane past it is
  finalized from its checkpoint into a certified partial answer.
* the **count** op (the certified match count with no ids), label
  filters, and int8 and tiered corpora (the result stage is one
  ``finalize_results`` call on the served corpus, which reranks a tiered
  corpus's guard band from host memory).
* **latency accounting**: every response carries ``timings`` (queue /
  service / total) and feeds log-bucket histograms (``latency_summary``).

Departures from the reference, none of which changes an answer: batches
are not padded to powers of two (the reference pads to bound its jit
variants; eager PyTorch needs none and the lanes are independent); a
response's clock is read after its result tensors reach the host, so its
latency includes the device work that CUDA's asynchronous launches would
otherwise leave out; a micro-batch's queries and radii go to the device as
one copy per tensor. The live index (``live=``), fault injection, retries
and replication (``injector=``, ``retry=``, ``replicas=``, ``hedge=``) and
sharded serving (``mesh=``, ``sharded=``) are later slices of the port and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..core.corpus import corpus_dtype_name
from ..core.engine import RangeSearchEngine
from ..core.labels import LabelFilter, make_label_filter
from ..core.range_search import (
    RangeConfig, RangeResult, finalize_results, greedy_coverage, greedy_lane_done,
    greedy_resume_batch, greedy_seed_batch, range_phase1, range_search_compacted,
)
from ..fault.errors import DEADLINE_EXPIRED, QUEUE_FULL
from ..utils import INVALID_ID
from .latency import LatencyHistogram
from .scheduler import LaneScheduler

#: ops a Request may carry. "count" is the aggregate-only query: the
#: certified match count (post-rerank, the number a range answer's ``count``
#: carries) with no ids/dists payload. "insert"/"delete" need a live index.
REQUEST_OPS = ("range", "count", "insert", "delete")

_LATER = {
    "live": "ROADMAP.md §1, item 2: the live index",
    "injector": "ROADMAP.md §1, item 3: fault tolerance",
    "retry": "ROADMAP.md §1, item 3: fault tolerance",
    "replicas": "ROADMAP.md §1, item 3: fault tolerance",
    "hedge": "ROADMAP.md §1, item 3: fault tolerance",
    "mesh": "ROADMAP.md §1, item 4: multi-device",
    "sharded": "ROADMAP.md §1, item 4: multi-device",
}


@dataclasses.dataclass(kw_only=True)
class Request:
    """One unit of admitted work, op-tagged. Construct by keyword.

    ``deadline_s`` is a latency budget in seconds from ``submit``: a range
    request still queued past it is shed with ``code="deadline_expired"``;
    one whose phase-2 lane is mid-search is finalized into a certified
    partial answer (``complete=False``). ``None`` never expires.

    ``filter_labels`` (range/count on a labeled engine) restricts the answer
    to points carrying those labels: ``filter_mode="and"`` all of them,
    ``"or"`` any. ``labels`` tags an inserted vector (live index only)."""
    req_id: int
    op: str = "range"                   # range | count | insert | delete
    query: Optional[np.ndarray] = None  # range/count/insert: the vector
    radius: Optional[float] = None      # per-request; batches mix radii freely
    deadline_s: Optional[float] = None  # latency budget (seconds from submit)
    delete_ids: Optional[np.ndarray] = None  # delete: external ids to remove
    filter_labels: Optional[np.ndarray] = None  # range: predicate label ids
    filter_mode: str = "and"            # range: "and" | "or" over filter_labels
    labels: Optional[np.ndarray] = None  # insert: label ids of the new vector


@dataclasses.dataclass(kw_only=True)
class Response:
    """Op-tagged answer. ``timings`` splits ``latency_s`` into queue
    (submit -> drain) and service (drain -> response) seconds.

    ``complete`` is False for a certified partial (deadline-truncated);
    ``coverage`` estimates the searched fraction (1.0 when complete);
    ``code`` is the ``fault.errors`` reason (None when healthy). Partial
    results are truncated, never corrupted: every returned id is within
    the request radius by its exact distance."""
    req_id: int
    op: str = "range"               # range | count | insert | delete | error
    ids: np.ndarray = None          # count op: empty (count-only payload)
    dists: np.ndarray = None
    count: int = 0
    overflow: bool = False
    es_stopped: bool = False
    latency_s: float = 0.0
    radius: float = float("nan")  # the radius this request was answered at
    epoch: int = 0                # index epoch (0: a static engine)
    timings: Optional[dict] = None  # {"queue_s", "service_s", "total_s"}
    complete: bool = True           # False: partial (deadline)
    coverage: float = 1.0           # searched fraction estimate (1.0 = full)
    code: Optional[str] = None      # fault.errors taxonomy; None = healthy
    shards_ok: Optional[int] = None     # sharded serving (a later slice)
    shards_total: Optional[int] = None
    replicas_ok: Optional[int] = None   # replicated serving (a later slice)
    replicas_total: Optional[int] = None
    filtered: bool = False          # answered under a label predicate


@dataclasses.dataclass
class ServerConfig:
    max_batch: int = 256
    max_wait_s: float = 0.005
    default_radius: float = 1.0
    es_radius_factor: float = 0.0   # >0 enables early stopping at factor*r
    expand_width: int = 0           # DEPRECATED: deploy-time search overrides
                                    # belong on EngineDeployConfig.overrides()
    max_queue: int = 8192           # admission bound; 0 disables admission
    auto_consolidate: bool = True   # live engines (a later slice)
    # -- continuous batching (tail-latency mode) ----------------------------
    continuous: bool = False        # persistent-lane phase-2 scheduling
    lanes: int = 32                 # pool width (rounded up to pow2)
    slice_rounds: int = 8           # greedy expansions per lane per tick
    effort_threshold: float = 64.0  # predicted matches >= this -> heavy bucket

    def __post_init__(self):
        if self.expand_width > 0:
            warnings.warn(
                "ServerConfig.expand_width is deprecated; deploy-time "
                "search overrides belong on "
                "EngineDeployConfig.overrides(expand_width=...)",
                DeprecationWarning, stacklevel=3)


class RangeServer:
    def __init__(
        self,
        engine: Optional[RangeSearchEngine],
        cfg: RangeConfig,
        server_cfg: ServerConfig = ServerConfig(),
        *,
        mesh=None,
        sharded=None,
        live=None,
        effort=None,
        injector=None,
        retry=None,
        replicas: int = 1,
        hedge=None,
        clock=time.perf_counter,
    ):
        """``effort`` is a fitted ``models.EffortPredictor``; continuous
        mode uses it to split each drain into cheap/heavy dispatches.
        ``clock`` is the monotonic time source of queueing and deadline
        decisions, injectable so tests advance a fake clock. The arguments
        of later slices (``mesh``, ``sharded``, ``live``, ``injector``,
        ``retry``, ``replicas`` > 1, ``hedge``) raise."""
        given = dict(mesh=mesh, sharded=sharded, live=live, injector=injector,
                     retry=retry, hedge=hedge, replicas=None if replicas == 1 else replicas)
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"RangeServer({name}=...) is not ported yet ({_LATER[name]})")
        if engine is None:
            raise ValueError("need an engine")
        self.engine = engine
        if server_cfg.expand_width > 0:
            cfg = dataclasses.replace(cfg, search=dataclasses.replace(
                cfg.search, expand_width=server_cfg.expand_width))
        # the declarative SearchConfig.corpus_dtype is a deploy contract:
        # what the config promises must be what the served corpus stores
        actual = corpus_dtype_name(engine.points)
        if cfg.search.corpus_dtype != actual:
            raise ValueError(
                f"SearchConfig.corpus_dtype={cfg.search.corpus_dtype!r} but "
                f"the served corpus stores {actual!r}")
        self.cfg = cfg
        self.scfg = server_cfg
        self.effort = effort
        self._clock = clock
        self.queue: deque[tuple[Request, float]] = deque()
        self._pool: Optional[LaneScheduler] = None
        if server_cfg.continuous:
            if cfg.mode != "greedy":
                raise ValueError("continuous batching schedules the greedy "
                                 f"phase; cfg.mode={cfg.mode!r}")
            self._pool = LaneScheduler(engine.points, engine.graph, cfg,
                                       server_cfg.lanes, server_cfg.slice_rounds)
        self.hist = {"all": LatencyHistogram(), "service": LatencyHistogram()}
        self.stats = {
            "served": 0, "batches": 0, "es_stopped": 0, "overflow": 0,
            # bounded admission: requests shed at the queue limit
            "rejected": 0,
            # live-index counters (a later slice: they stay 0)
            "inserts": 0, "deletes": 0, "consolidations": 0, "epoch": 0,
            # int8 corpus: guard-band candidates exact-reranked
            "reranked": 0,
            # radius dispersion: mixed-radius batches and running moments
            "mixed_radius_batches": 0,
            "radius_min": float("inf"), "radius_max": float("-inf"),
            "radius_sum": 0.0, "radius_sumsq": 0.0,
            # continuous batching: pool_rotations counts ticks after which
            # some lanes stayed in flight while others retired or waited
            "pool_admitted": 0, "pool_retired": 0, "pool_ticks": 0,
            "pool_rotations": 0, "pool_oneshot": 0,
            "bucket_cheap": 0, "bucket_heavy": 0,
            # deadlines: shed while queued / finalized as certified partials;
            # the shard and replica counters belong to later slices
            "deadline_shed": 0, "deadline_partial": 0,
            "shard_retries": 0, "shards_lost": 0, "degraded_batches": 0,
            "hedges_fired": 0, "hedge_wins": 0, "breaker_trips": 0,
            "replicas_lost": 0, "replicas_recovered": 0,
            # filtered retrieval: micro-batches with a predicate lane
            "filtered_batches": 0, "filtered_requests": 0,
            # aggregate-only workload: op="count" requests served
            "count_requests": 0,
        }

    # -- served view ---------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.engine.device

    def _labels(self):
        return self.engine.labels

    def _num_labels(self) -> int:
        """Label-id space the packed store can represent (32 per word)."""
        lab = self._labels()
        return 0 if lab is None else 32 * int(lab.shape[-1])

    def _filter_of(self, reqs) -> Optional[LabelFilter]:
        """The per-lane predicate of ``reqs`` (host tensors), or None when no
        lane filters; unfiltered lanes get the all-pass predicate."""
        if all(rq.filter_labels is None for rq in reqs):
            return None
        return make_label_filter([rq.filter_labels for rq in reqs], self._num_labels(),
                                 modes=[rq.filter_mode for rq in reqs])

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _finalize(self, qj, rj, res: RangeResult, lf) -> RangeResult:
        """The result stage on the served corpus: the label drop, then the
        int8 guard-band rerank (from host memory for a tiered corpus)."""
        return finalize_results(self.engine.points, qj, rj, res, self.cfg, None,
                                None if lf is None else self._labels(), lf)

    # -- admission -------------------------------------------------------
    def submit(self, req: Request) -> Optional[Response]:
        """Admit a request; returns ``None`` on admission, or a structured
        rejection ``Response(op="error", code="queue_full")`` when the queue
        is at ``max_queue`` (counted and delivered). Malformed requests raise
        here, at the caller, before they can join a micro-batch."""
        if req.op not in REQUEST_OPS:
            raise ValueError(f"unknown op {req.op!r}")
        if req.op in ("insert", "delete"):
            raise ValueError(f"{req.op!r} requests need a live index")
        if req.query is None:
            raise ValueError(f"{req.op!r} requests need a query vector")
        if req.filter_labels is not None:
            if self._labels() is None:
                raise ValueError(
                    "served corpus has no labels attached; filtered range "
                    "requests need a labeled engine/index")
            if req.filter_mode not in ("and", "or"):
                raise ValueError(f"filter_mode must be 'and' or 'or', "
                                 f"got {req.filter_mode!r}")
            fl = np.atleast_1d(np.asarray(req.filter_labels))
            if fl.size and int(fl.max()) >= self._num_labels():
                raise ValueError(
                    f"filter label id {int(fl.max())} out of range for a "
                    f"{self._num_labels()}-label corpus")
        if req.labels is not None:
            raise ValueError("labels= applies to insert requests")
        if req.deadline_s is not None and req.deadline_s < 0:
            raise ValueError("deadline_s must be >= 0 (or None for no budget)")
        if len(self.queue) >= self.scfg.max_queue:
            self.stats["rejected"] += 1
            return self._record(self._error_response(req, QUEUE_FULL, latency_s=0.0))
        self.queue.append((req, self._clock()))
        return None

    @staticmethod
    def _error_response(req: Request, code: str,
                        latency_s: float = 0.0, timings=None) -> Response:
        return Response(
            req_id=req.req_id, op="error", ids=np.zeros(0, np.int64),
            dists=np.zeros(0, np.float32), count=0,
            latency_s=latency_s, timings=timings,
            radius=float("nan") if req.radius is None else float(req.radius),
            complete=False, coverage=0.0, code=code)

    @staticmethod
    def _deadline_at(req: Request, arrive: float) -> float:
        return float("inf") if req.deadline_s is None else arrive + req.deadline_s

    def _shed_expired(self, batch, svc0: float):
        """Split a drained micro-batch into (alive, expired-error responses).
        Expiry is strict (``now > deadline``), so a zero budget still gets
        its work done under a frozen test clock."""
        alive, out = [], []
        for rq, arrive in batch:
            if svc0 > self._deadline_at(rq, arrive):
                self.stats["deadline_shed"] += 1
                out.append(self._record(self._error_response(
                    rq, DEADLINE_EXPIRED, latency_s=svc0 - arrive,
                    timings=self._timings(arrive, svc0, svc0))))
            else:
                alive.append((rq, arrive))
        return alive, out

    def pending(self) -> int:
        return len(self.queue)

    def in_flight(self) -> int:
        """Lanes checkpointed in the continuous pool (0 in lockstep mode)."""
        return self._pool.occupancy if self._pool is not None else 0

    # -- batching ------------------------------------------------------------
    def _drain(self) -> list[tuple[Request, float]]:
        out = []
        t0 = self._clock()
        while self.queue and len(out) < self.scfg.max_batch:
            out.append(self.queue.popleft())
            if not self.queue and (self._clock() - t0) < self.scfg.max_wait_s:
                time.sleep(0)  # yield; more requests may land in a real server
                break
        return out

    def _batch_arrays(self, reqs):
        q = np.stack([np.asarray(rq.query, np.float32) for rq in reqs])
        radii = np.asarray([self.scfg.default_radius if rq.radius is None else rq.radius
                            for rq in reqs], np.float32)
        return q, radii

    def _es(self, rj: torch.Tensor):
        return (self.scfg.es_radius_factor * rj
                if self.scfg.es_radius_factor > 0 else None)

    # -- response plumbing ---------------------------------------------------
    def _record(self, resp: Response) -> Response:
        self.hist["all"].record(resp.latency_s)
        if resp.timings is not None:
            self.hist["service"].record(resp.timings["service_s"])
        if resp.op not in self.hist:
            self.hist[resp.op] = LatencyHistogram()
        self.hist[resp.op].record(resp.latency_s)
        return resp

    def latency_summary(self) -> dict:
        """Per-op + end-to-end latency quantiles (ms); see LatencyHistogram."""
        return {k: h.summary() for k, h in self.hist.items()}

    @staticmethod
    def _timings(arrive: float, svc0: float, now: float) -> dict:
        return {"queue_s": svc0 - arrive, "service_s": now - svc0,
                "total_s": now - arrive}

    def _track_radii(self, radii: np.ndarray) -> None:
        rb = np.asarray(radii, np.float64)
        if rb.size == 0:
            return
        self.stats["mixed_radius_batches"] += int(rb.min() != rb.max())
        self.stats["radius_min"] = min(self.stats["radius_min"], float(rb.min()))
        self.stats["radius_max"] = max(self.stats["radius_max"], float(rb.max()))
        self.stats["radius_sum"] += float(rb.sum())
        self.stats["radius_sumsq"] += float((rb * rb).sum())

    def _emit(self, res: RangeResult, reqs, arrive, radii, svc0s,
              extras=None) -> list[Response]:
        """Turn result rows into recorded Responses, row i answering
        ``reqs[i]``. The result tensors reach the host first, and only then
        is the clock read, so a latency includes the search's device work.
        ``extras`` (one dict a row) merges degradation fields."""
        ids, dists, counts, over, ess, nrr = (
            t.cpu().numpy() for t in (res.ids, res.dists, res.count, res.overflow,
                                      res.es_stopped, res.n_rerank))
        now = self._clock()
        out = []
        for i, rq in enumerate(reqs):
            row = ids[i]
            valid = row != INVALID_ID
            if rq.op == "count":  # certified count only, no payload
                r_ids, r_dists = np.zeros(0, row.dtype), np.zeros(0, np.float32)
                self.stats["count_requests"] += 1
            else:
                r_ids, r_dists = row[valid], dists[i][valid]
            out.append(self._record(Response(
                req_id=rq.req_id, op=rq.op, ids=r_ids, dists=r_dists,
                count=int(counts[i]), overflow=bool(over[i]), es_stopped=bool(ess[i]),
                latency_s=now - arrive[i], radius=float(radii[i]),
                timings=self._timings(arrive[i], svc0s[i], now),
                filtered=rq.filter_labels is not None,
                **(extras[i] if extras is not None else {}))))
            self.stats["es_stopped"] += int(ess[i])
            self.stats["overflow"] += int(over[i])
            self.stats["reranked"] += int(nrr[i])
        self.stats["served"] += len(out)
        return out

    # -- lockstep execution --------------------------------------------------
    def step(self) -> list[Response]:
        """Serve one micro-batch from the queue: one ``range_search_compacted``
        call, every lane at its own radius. In continuous mode a step also
        advances the lane pool one tick and retires finished lanes."""
        if self._pool is not None:
            return self._step_continuous()
        batch = self._drain()
        if not batch:
            return []
        svc0 = self._clock()
        batch, out = self._shed_expired(batch, svc0)
        if not batch:
            return out
        reqs = [b[0] for b in batch]
        arrive = [b[1] for b in batch]
        q, radii = self._batch_arrays(reqs)
        qj, rj = self._to_device(q), self._to_device(radii)
        lf = self._filter_of(reqs)
        eng = self.engine
        res = range_search_compacted(
            corpus=eng.points, graph=eng.graph, queries=qj, start_ids=eng.start_ids,
            r=rj, cfg=self.cfg, es_radius=self._es(rj),
            labels=None if lf is None else eng.labels, label_filter=lf)
        out.extend(self._emit(res, reqs, arrive, radii, [svc0] * len(reqs)))
        self.stats["batches"] += 1
        self.stats["filtered_batches"] += int(lf is not None)
        self.stats["filtered_requests"] += sum(rq.filter_labels is not None for rq in reqs)
        self._track_radii(radii)
        return out

    # -- continuous execution ------------------------------------------------
    def _step_continuous(self) -> list[Response]:
        """One continuous-batching step: drain, effort-split phase-1
        dispatches, then retire lanes past their deadline, tick the pool and
        retire finished lanes. Lanes answered at phase 1 return from the
        step they were drained in; saturated lanes ride the pool."""
        batch = self._drain()
        svc0 = self._clock()
        batch, out = self._shed_expired(batch, svc0)
        if batch:
            reqs = [b[0] for b in batch]
            arrive = [b[1] for b in batch]
            q, radii = self._batch_arrays(reqs)
            heavy = np.zeros(len(reqs), bool)
            if self.effort is not None and len(reqs) > 1:
                heavy = self.effort.predict(q, radii) >= self.scfg.effort_threshold
            self.stats["bucket_cheap"] += int((~heavy).sum())
            self.stats["bucket_heavy"] += int(heavy.sum())
            # cheap bucket first: point queries never queue behind the heavy
            for sel in (np.nonzero(~heavy)[0], np.nonzero(heavy)[0]):
                if len(sel):
                    out.extend(self._dispatch_phase1(
                        [reqs[i] for i in sel], [arrive[i] for i in sel],
                        q[sel], radii[sel], svc0))
            self._track_radii(radii)
            self.stats["batches"] += 1
            nf = sum(rq.filter_labels is not None for rq in reqs)
            self.stats["filtered_batches"] += int(nf > 0)
            self.stats["filtered_requests"] += nf
        # deadlines before the tick: a lane past its budget is finalized from
        # its checkpoint (a certified partial) instead of resumed, freeing
        # its slot
        expired = self._pool.expired(self._clock())
        if len(expired):
            out.extend(self._respond_greedy(*self._pool.retire(expired), expired=True))
        before = self._pool.occupancy
        finished = self._pool.tick()
        self.stats["pool_ticks"] = self._pool.ticks
        if before > len(finished):
            # a lane survived the tick while the server kept serving around it
            self.stats["pool_rotations"] += 1
        if len(finished):
            out.extend(self._respond_greedy(*self._pool.retire(finished)))
        return out

    def _dispatch_phase1(self, reqs, arrive, q, radii, svc0) -> list[Response]:
        """Phase 1 for one dispatch: answer the unsaturated lanes now, seed
        the saturated ones into the pool (those that do not fit run to
        completion at once)."""
        qj, rj = self._to_device(q), self._to_device(radii)
        eng = self.engine
        st, res, need = range_phase1(eng.points, eng.graph, qj, eng.start_ids, rj,
                                     self.cfg, es_radius=self._es(rj))
        need_h = need.cpu().numpy()
        out = []
        # phase 1 walks unfiltered (predicates act at the result stage):
        # the predicate applies here for direct lanes, at retirement for
        # pooled ones
        direct = np.nonzero(~need_h)[0]
        if len(direct):
            d = self._to_device(direct)
            dreqs = [reqs[i] for i in direct]
            fin = self._finalize(qj[d], rj[d], res.select(d), self._filter_of(dreqs))
            out.extend(self._emit(fin, dreqs, [arrive[i] for i in direct],
                                  radii[direct], [svc0] * len(direct)))
        lanes = np.nonzero(need_h)[0]
        if len(lanes):
            sel = self._to_device(lanes)
            seeded = greedy_seed_batch(eng.points, st.select(sel), rj[sel],
                                       self.cfg.result_cap, self.cfg.search)
            nv1, nd1, es1 = torch.stack([st.n_visited[sel], st.n_dist[sel],
                                         st.es_stopped[sel].to(torch.int32)]).cpu().numpy()
            metas = [dict(req=reqs[i], arrive=arrive[i], svc0=svc0,
                          radius=float(radii[i]),
                          deadline_at=self._deadline_at(reqs[i], arrive[i]),
                          n_visited=int(nv1[j]), n_dist=int(nd1[j]), es=bool(es1[j]))
                     for j, i in enumerate(lanes)]
            k = len(lanes)
            qs, rs = qj[sel], rj[sel]
            fit = min(k, len(self._pool.free_slots()))
            if fit:
                self._pool.admit(seeded, np.arange(fit), qs, rs, metas[:fit])
                self.stats["pool_admitted"] += fit
            if fit < k:
                # pool full: the overflow lanes run to completion in one
                # slice (the same results: the slice width is a latency knob)
                out.extend(self._oneshot(seeded, np.arange(fit, k), qs, rs, metas[fit:]))
        return out

    def _oneshot(self, seeded, sel, qs, rs, metas) -> list[Response]:
        idx = self._to_device(sel)
        g = greedy_resume_batch(
            self.engine.points, self.engine.graph, qs[idx], rs[idx], seeded.select(idx),
            torch.ones(len(sel), dtype=torch.bool, device=self.device),
            self.cfg.result_cap, self.cfg.frontier_rounds, self.cfg.frontier_rounds,
            self.cfg.search)
        _, over = greedy_lane_done(g, self.cfg.frontier_rounds)
        self.stats["pool_oneshot"] += len(sel)
        return self._respond_greedy(g, qs[idx], rs[idx], over, metas)

    def _respond_greedy(self, g, qs, rs, over, metas, *,
                        expired: bool = False) -> list[Response]:
        """Finalize retired greedy lanes (pool or one-shot) into Responses.

        ``expired=True`` marks deadline retirements: the checkpoints are
        finalized as they are (the greedy loop only ever appends in-range
        nodes, and the result stage still reranks), so the partial answer is
        certified, only possibly short; ``coverage`` is the lane's
        visited-frontier fraction."""
        k = len(metas)
        host = np.asarray([[m["n_visited"], m["n_dist"], m["es"]] for m in metas],
                          np.int32).reshape(k, 3)
        nv, nd, esf = self._to_device(host).unbind(1)
        res = RangeResult(
            ids=g.res_ids, dists=g.res_dists, count=g.res_count,
            overflow=self._to_device(over), n_visited=nv, n_dist=nd + g.n_dist,
            es_stopped=esf.bool(),
            phase2=torch.ones(k, dtype=torch.bool, device=self.device),
            n_rerank=torch.zeros(k, dtype=torch.int32, device=self.device))
        extras = None
        if expired:
            cov = greedy_coverage(g)
            extras = [dict(complete=False, coverage=float(cov[i]), code=DEADLINE_EXPIRED)
                      for i in range(k)]
            self.stats["deadline_partial"] += k
        reqs = [m["req"] for m in metas]
        res = self._finalize(qs, rs, res, self._filter_of(reqs))
        self.stats["pool_retired"] += k
        return self._emit(res, reqs, [m["arrive"] for m in metas],
                          np.asarray([m["radius"] for m in metas], np.float32),
                          [m["svc0"] for m in metas], extras=extras)

    # -- monitoring / drain --------------------------------------------------
    def radius_dispersion(self) -> dict:
        """Mean/std/min/max of served radii + mixed-batch count (monitoring)."""
        n = max(self.stats["served"], 1)
        mean = self.stats["radius_sum"] / n
        var = max(self.stats["radius_sumsq"] / n - mean * mean, 0.0)
        return dict(mean=mean, std=var ** 0.5,
                    min=self.stats["radius_min"], max=self.stats["radius_max"],
                    mixed_radius_batches=self.stats["mixed_radius_batches"])

    def run_until_drained(self) -> list[Response]:
        out = []
        while self.queue or self.in_flight():
            out.extend(self.step())
        return out
