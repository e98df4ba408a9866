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
* **multi-shard** (lockstep only): over a ``dist.ShardedCorpus``
  (``sharded=``), a micro-batch goes through the collective
  ``dist.sharded_range_search`` when a ``mesh`` is given (and neither an
  injector nor a tiered corpus), else through the fault-tolerant host
  fan-out (``fault.fault_tolerant_sharded_search``: per-shard retries with
  ``retry`` backoff, validated answers, and on permanent shard loss every
  response of the batch annotated ``shards_ok``/``shards_total``,
  ``code="shard_lost"``). Over a mesh of several ranks every rank runs the
  same server over the same requests and gets the same responses.
* **replication** (``replicas=`` > 1, ``hedge=``; host fan-out only): the
  sharded corpus served R-way replicated through
  ``fault.replicated_fan_out`` (failover, hedged reads, per-replica circuit
  breakers); every response carries ``replicas_ok``/``replicas_total``,
  with ``code="replica_lost"`` when the answer is whole but a replica
  failed; each lockstep step first runs the fleet's recovery sweep.
* **live mutation**: over a ``live.LiveIndex`` (``live=``), ``insert`` and
  ``delete`` requests ride the same queue. A micro-batch's mutations apply
  first (one coalesced insert, then one coalesced delete), the epoch
  snapshot advances once, and the batch's queries are answered against
  that one consistent view (graph, corpus, tombstones, external ids).
  Continuous mode first finishes its in-flight lanes on the snapshot they
  were admitted under, since a consolidation moves slots.
* **latency accounting**: every response carries ``timings`` (queue /
  service / total) and feeds log-bucket histograms (``latency_summary``).

Departures from the reference, none of which changes an answer: batches
are not padded to powers of two (the reference pads to bound its jit
variants; eager PyTorch needs none and the lanes are independent); a
response's clock is read after its result tensors reach the host, so its
latency includes the device work that CUDA's asynchronous launches would
otherwise leave out; a micro-batch's queries and radii go to the device as
one copy per tensor; over a live index a lockstep micro-batch searches the
snapshot by slot id and maps the ids to external ids on the host, as the
continuous path does (the reference calls ``LiveSnapshot.range``).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..core.corpus import corpus_dtype_name, hot_arm
from ..core.engine import RangeSearchEngine
from ..core.labels import LabelFilter, make_label_filter, make_mask
from ..core.range_search import (
    RangeConfig, RangeResult, finalize_results, greedy_coverage, greedy_lane_done,
    greedy_resume_batch, greedy_seed_batch, range_phase1, range_search_compacted,
)
from ..dist.sharded_engine import sharded_range_search
from ..fault.degraded import RetryPolicy, fault_tolerant_sharded_search
from ..fault.errors import DEADLINE_EXPIRED, QUEUE_FULL
from ..fault.replica import HedgePolicy, ReplicaFleet, ReplicatedCorpus
from ..utils import INVALID_ID
from .latency import LatencyHistogram
from .scheduler import LaneScheduler

#: ops a Request may carry. "count" is the aggregate-only query: the
#: certified match count (post-rerank, the number a range answer's ``count``
#: carries) with no ids/dists payload. "insert"/"delete" need a live index.
REQUEST_OPS = ("range", "count", "insert", "delete")


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
    shards_ok: Optional[int] = None     # sharded fan-out: shards merged
    shards_total: Optional[int] = None  # sharded fan-out: shards configured
    replicas_ok: Optional[int] = None     # replicated serving: healthy replicas
    replicas_total: Optional[int] = None  # replicated serving: S * R
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
    auto_consolidate: bool = True   # live engines: threshold consolidation
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
        hedge: Optional[HedgePolicy] = None,
        clock=time.perf_counter,
    ):
        """``live`` is a ``live.LiveIndex``; it takes the place of ``engine``
        (pass ``engine=None``) and enables insert/delete requests.
        ``sharded`` is a ``dist.ShardedCorpus`` (``engine=None``), served
        through the collective ``dist.sharded_range_search`` over ``mesh``
        or, without a mesh or with an ``injector`` (a seeded
        ``fault.FaultInjector`` for chaos tests), through the fault-tolerant
        host fan-out with ``retry`` (a ``fault.RetryPolicy``).
        ``effort`` is a fitted ``models.EffortPredictor``; continuous
        mode uses it to split each drain into cheap/heavy dispatches.
        ``clock`` is the monotonic time source of queueing and deadline
        decisions, injectable so tests advance a fake clock.

        ``replicas=R`` (R > 1) serves ``sharded`` R-way replicated through
        the hedged fan-out (``sharded`` may also be a built
        ``fault.ReplicatedCorpus``, or a ``fault.ReplicaFleet`` to share
        breaker state); ``hedge`` is a ``fault.HedgePolicy``. Replica health
        rides the completeness contract: ``coverage < 1.0`` only when every
        replica of a shard is exhausted, ``code="replica_lost"`` when the
        answer is whole but redundancy is degraded. ``step()`` runs one
        fleet recovery sweep a micro-batch."""
        if replicas > 1 and sharded is None:
            raise ValueError("replicas > 1 needs a sharded corpus")
        if engine is None and live is None and sharded is None:
            raise ValueError("need an engine, a sharded corpus, or a live index")
        if injector is not None and sharded is None:
            raise ValueError("fault injection targets shards; pass sharded=")
        self.fleet: Optional[ReplicaFleet] = None
        if isinstance(sharded, ReplicaFleet):
            self.fleet = sharded
        elif isinstance(sharded, ReplicatedCorpus):
            self.fleet = ReplicaFleet(sharded)
        elif replicas > 1:
            self.fleet = ReplicaFleet(ReplicatedCorpus.replicate(sharded, replicas))
        if self.fleet is not None:
            if mesh is not None:
                raise ValueError("replicated serving is host fan-out; "
                                 "drop mesh= or serve unreplicated")
            sharded = self.fleet.corpus.replica(0)
        self.hedge = hedge
        self.engine = engine
        self.live = live
        if server_cfg.expand_width > 0:
            cfg = dataclasses.replace(cfg, search=dataclasses.replace(
                cfg.search, expand_width=server_cfg.expand_width))
        # the declarative SearchConfig.corpus_dtype is a deploy contract:
        # what the config promises must be what the served corpus stores
        if live is not None:
            served = live.points
        elif sharded is not None:
            served = sharded.points
        else:
            served = engine.points
        actual = corpus_dtype_name(served)
        if cfg.search.corpus_dtype != actual:
            raise ValueError(
                f"SearchConfig.corpus_dtype={cfg.search.corpus_dtype!r} but "
                f"the served corpus stores {actual!r}")
        self.cfg = cfg
        self.scfg = server_cfg
        self.mesh = mesh
        self.sharded = sharded
        self.effort = effort
        self.injector = injector
        self.retry = retry or RetryPolicy()
        self._clock = clock
        self.queue: deque[tuple[Request, float]] = deque()
        self._view = live.snapshot() if live is not None else None
        self._pool: Optional[LaneScheduler] = None
        if server_cfg.continuous:
            if sharded is not None or mesh is not None:
                raise ValueError("continuous batching is single-shard; "
                                 "drop continuous=True for sharded serving")
            if cfg.mode != "greedy":
                raise ValueError("continuous batching schedules the greedy "
                                 f"phase; cfg.mode={cfg.mode!r}")
            self._pool = LaneScheduler(self._device_corpus(), self._graph(), cfg,
                                       server_cfg.lanes, server_cfg.slice_rounds)
        self.hist = {"all": LatencyHistogram(), "service": LatencyHistogram()}
        self.stats = {
            "served": 0, "batches": 0, "es_stopped": 0, "overflow": 0,
            # bounded admission: requests shed at the queue limit
            "rejected": 0,
            # live mutation counters; epoch mirrors the served snapshot
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
            # shard_retries / shards_lost / degraded_batches come from the
            # sharded fan-out; the replica counters mirror ReplicaFleet.stats
            # (hedged reads fired and won, breakers opened, fleet membership)
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
    def _device_corpus(self):
        """The served corpus: the live snapshot's, else the engine's (the
        search code takes a tier's hot arm itself)."""
        return self._view.points if self.live is not None else self.engine.points

    def _graph(self):
        return self._view.graph if self.live is not None else self.engine.graph

    def _start_ids(self):
        return self._view.start_ids if self.live is not None else self.engine.start_ids

    def _tombstones(self):
        return self._view.tombstones if self.live is not None else None

    def _epoch(self) -> int:
        return self._view.epoch if self._view is not None else 0

    def _externalize(self, ids: np.ndarray) -> np.ndarray:
        if self.live is None:
            return ids
        from ..live.index import externalize_ids
        return externalize_ids(self._view.ext_ids, ids)

    @property
    def device(self) -> torch.device:
        if self.sharded is not None:
            return self.sharded.device
        return hot_arm(self._device_corpus()).device

    def _labels(self):
        """The served packed label rows, or None. A sharded corpus keeps
        labels per shard; here they only say whether a filter applies and
        how many labels there are."""
        if self.live is not None:
            return self._view.labels
        if self.sharded is not None:
            return self.sharded.labels
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
        """The result stage on the served corpus: the tombstone drop (a live
        snapshot), the label drop, then the int8 guard-band rerank (from host
        memory for a tiered corpus)."""
        return finalize_results(self._device_corpus(), qj, rj, res, self.cfg,
                                self._tombstones(), None if lf is None else self._labels(), lf)

    # -- admission -------------------------------------------------------
    def submit(self, req: Request) -> Optional[Response]:
        """Admit a request; returns ``None`` on admission, or a structured
        rejection ``Response(op="error", code="queue_full")`` when the queue
        is at ``max_queue`` (counted and delivered). Malformed requests raise
        here, at the caller, before they can join a micro-batch."""
        if req.op not in REQUEST_OPS:
            raise ValueError(f"unknown op {req.op!r}")
        if req.op in ("insert", "delete") and self.live is None:
            raise ValueError(f"{req.op!r} requests need a live index")
        if req.op == "delete":
            if req.delete_ids is None:
                raise ValueError("delete requests need delete_ids")
        elif req.query is None:
            raise ValueError(f"{req.op!r} requests need a query vector")
        if req.filter_labels is not None:
            if req.op not in ("range", "count"):
                raise ValueError("filter_labels applies to range/count requests")
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
            if req.op != "insert":
                raise ValueError("labels= applies to insert requests")
            if self.live is None or self.live.labels is None:
                raise ValueError("labeled inserts need a labeled live index")
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
        Only queries expire: a mutation is wanted however late it applies.
        Expiry is strict (``now > deadline``), so a zero budget still gets
        its work done under a frozen test clock."""
        alive, out = [], []
        for rq, arrive in batch:
            if rq.op in ("range", "count") and svc0 > self._deadline_at(rq, arrive):
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
        ids = self._externalize(ids)
        epoch = self._epoch()
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
                latency_s=now - arrive[i], radius=float(radii[i]), epoch=epoch,
                timings=self._timings(arrive[i], svc0s[i], now),
                filtered=rq.filter_labels is not None,
                **(extras[i] if extras is not None else {}))))
            self.stats["es_stopped"] += int(ess[i])
            self.stats["overflow"] += int(over[i])
            self.stats["reranked"] += int(nrr[i])
        self.stats["served"] += len(out)
        return out

    # -- mutation ------------------------------------------------------------
    def _apply_mutations(self, muts, svc0: float) -> list[Response]:
        """Apply a micro-batch's mutations: ONE coalesced insert, then ONE
        coalesced delete. The reorder is sound because external ids are
        never reused: an insert and a delete of the same id in one batch end
        in the same state either way, and a delete cannot precede "its"
        insert (the id did not exist when the delete was submitted)."""
        out = []
        ins = [(rq, t) for rq, t in muts if rq.op == "insert"]
        dels = [(rq, t) for rq, t in muts if rq.op == "delete"]
        if ins:
            lab = None
            if self.live.labels is not None:
                nl = 32 * int(self.live.labels.shape[1])
                lab = np.stack([make_mask([] if rq.labels is None else rq.labels, nl)
                                for rq, _ in ins])
            ext = self.live.insert(np.stack([np.asarray(rq.query, np.float32)
                                             for rq, _ in ins]), labels=lab)
            self.stats["inserts"] += len(ins)
            now = self._clock()
            for (rq, arrive), e in zip(ins, ext):
                out.append(self._record(Response(
                    req_id=rq.req_id, op="insert", ids=np.asarray([e], np.int64),
                    dists=np.zeros(1, np.float32), count=1,
                    latency_s=now - arrive, epoch=self.live.epoch,
                    timings=self._timings(arrive, svc0, now))))
        if dels:
            per_req = [np.atleast_1d(np.asarray(rq.delete_ids, np.int64)) for rq, _ in dels]
            self.stats["deletes"] += self.live.delete(np.concatenate(per_req))
            now = self._clock()
            for (rq, arrive), ids in zip(dels, per_req):
                out.append(self._record(Response(
                    req_id=rq.req_id, op="delete", ids=ids,
                    dists=np.zeros(len(ids), np.float32), count=len(ids),
                    latency_s=now - arrive, epoch=self.live.epoch,
                    timings=self._timings(arrive, svc0, now))))
        return out

    def _mutate(self, batch, svc0: float) -> tuple[list, list[Response]]:
        """Split off and apply a drained batch's mutations (live index only),
        consolidate past the threshold, refresh the snapshot. Returns (the
        queries, the mutations' responses)."""
        if self.live is None:
            return batch, []
        muts = [b for b in batch if b[0].op in ("insert", "delete")]
        batch = [b for b in batch if b[0].op in ("range", "count")]
        out = []
        if muts:
            # continuous: in-flight checkpoints must not cross an epoch, so
            # they finish on the snapshot they were admitted under first
            if self._pool is not None:
                out.extend(self._finish_pool())
            out.extend(self._apply_mutations(muts, svc0))
            if self.scfg.auto_consolidate and self.live.maybe_consolidate():
                self.stats["consolidations"] += 1
            self._view = self.live.snapshot()
            if self._pool is not None:
                self._pool.rebind(self._device_corpus(), self._graph())
            if self._pool is None and not batch:
                self.stats["batches"] += 1
        self.stats["epoch"] = self._view.epoch
        return batch, out

    # -- lockstep execution --------------------------------------------------
    def _execute(self, qj: torch.Tensor, rj: torch.Tensor, lf: Optional[LabelFilter]):
        """One micro-batch's search: ``(RangeResult, DegradedResult | None)``,
        the second only from the sharded fan-out (no mesh, an injector, a
        replica fleet or a tiered corpus)."""
        es = self._es(rj)
        if self.sharded is not None:
            if self.mesh is not None and self.injector is None and self.sharded.tiers is None:
                return sharded_range_search(
                    mesh=self.mesh, corpus=self.sharded, queries=qj, r=rj, cfg=self.cfg,
                    es_radius=es, label_filter=lf), None
            d = fault_tolerant_sharded_search(
                corpus=self.sharded, queries=qj, r=rj, cfg=self.cfg, es_radius=es,
                label_filter=lf, injector=self.injector, retry=self.retry,
                fleet=self.fleet, hedge=self.hedge)
            self.stats["degraded_batches"] += int(not d.complete)
            self.stats["shard_retries"] += int(d.attempts.sum()) - d.shards_total
            self.stats["shards_lost"] += d.shards_total - d.shards_ok
            if self.fleet is not None:
                self.stats.update(self.fleet.stats)  # the fleet's running totals
            return d.result, d
        return range_search_compacted(
            corpus=self._device_corpus(), graph=self._graph(), queries=qj,
            start_ids=self._start_ids(), r=rj, cfg=self.cfg, es_radius=es,
            tombstones=self._tombstones(),
            labels=None if lf is None else self._labels(), label_filter=lf), None

    def step(self) -> list[Response]:
        """Serve one micro-batch from the queue: its mutations first (a live
        index), then one ``range_search_compacted`` call over its queries on
        one snapshot, every lane at its own radius. In continuous mode a
        step also advances the lane pool one tick and retires finished
        lanes. Over a replica fleet a lockstep step first runs the fleet's
        recovery sweep."""
        if self._pool is not None:
            return self._step_continuous()
        if self.fleet is not None:
            # rebuild lost replicas and re-admit them through the breaker's
            # half-open probe
            self.fleet.maintain()
            self.stats.update(self.fleet.stats)
        batch = self._drain()
        if not batch:
            return []
        svc0 = self._clock()
        batch, out = self._mutate(batch, svc0)
        batch, shed = self._shed_expired(batch, svc0)
        out.extend(shed)
        if not batch:
            return out
        reqs = [b[0] for b in batch]
        arrive = [b[1] for b in batch]
        q, radii = self._batch_arrays(reqs)
        qj, rj = self._to_device(q), self._to_device(radii)
        lf = self._filter_of(reqs)
        res, degraded = self._execute(qj, rj, lf)
        extras = None
        if degraded is not None:  # the shard health, on every response
            health = dict(shards_ok=degraded.shards_ok, shards_total=degraded.shards_total,
                          complete=degraded.complete, coverage=degraded.coverage,
                          code=degraded.code)
            if hasattr(degraded, "replica_ok"):  # the replicated fan-out
                health.update(replicas_ok=degraded.replicas_ok,
                              replicas_total=degraded.replicas_total)
            extras = [health] * len(reqs)
        out.extend(self._emit(res, reqs, arrive, radii, [svc0] * len(reqs), extras))
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
        batch, out = self._mutate(batch, svc0)
        batch, shed = self._shed_expired(batch, svc0)
        out.extend(shed)
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
        st, res, need = range_phase1(self._device_corpus(), self._graph(), qj,
                                     self._start_ids(), rj, self.cfg, es_radius=self._es(rj))
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
            seeded = greedy_seed_batch(self._device_corpus(), st.select(sel), rj[sel],
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
            self._device_corpus(), self._graph(), qs[idx], rs[idx], seeded.select(idx),
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

    def _finish_pool(self) -> list[Response]:
        """Tick the pool empty (the epoch barrier). Deadlines stay live:
        expired lanes finalize as certified partials between ticks."""
        out = []
        while self._pool.occupancy:
            expired = self._pool.expired(self._clock())
            if len(expired):
                out.extend(self._respond_greedy(*self._pool.retire(expired), expired=True))
                continue
            finished = self._pool.tick()
            self.stats["pool_ticks"] = self._pool.ticks
            if len(finished):
                out.extend(self._respond_greedy(*self._pool.retire(finished)))
        return out

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
