"""R-way shard replication: hedged fan-out, circuit breakers, recovery.

The shard-loss contract (``fault.degraded``) shrinks the answer when a
shard dies (``coverage < 1.0``), the wrong trade for duplicate detection
and moderation, where a missed duplicate is a correctness failure. This
module keeps the answer whole unless R failures coincide:

- :class:`ReplicatedCorpus` holds R bit-identical copies of a
  :class:`~repro_torch.dist.sharded_engine.ShardedCorpus`. That replicas
  are bit-equal is the load-bearing invariant: *which replica answers is
  unobservable in results*, so failover and hedging need no consistency
  reasoning.
- :class:`ReplicaFleet` is the control plane: per-(shard, replica)
  availability, a :class:`CircuitBreaker` per replica (consecutive-failure
  trip, half-open probe after a cooldown, injectable clock), per-shard
  latency histograms feeding :class:`HedgePolicy`, and recovery
  (``maintain()``) that re-admits rebuilt replicas through the breaker's
  half-open state.
- :func:`replicated_fan_out` is the replicated form of
  ``fault_tolerant_sharded_search``: per shard, walk the available replicas
  in rotation, failing over on timeout, error or garbage and hedging past
  slow primaries, and accept the first *validated* answer. A shard is lost
  only when every replica of it is exhausted; a complete answer served with
  replicas down carries ``code == "replica_lost"`` (health degraded,
  results not).

Live replication (mutations fanned to every replica of the owning shard, a
lost replica rebuilt from a checkpoint and the WAL's tail) lives in
:mod:`repro_torch.live.sharded`.

Every replica of every shard searches on the corpus's one device; the
worker threads (one a shard, and the wall-clock hedges' own pool) issue
onto the same device. ``parity_ok`` compares the replicas there, never
through host copies.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.beam_search import broadcast_radius
from ..core.corpus import QuantizedCorpus
from ..core.labels import LabelFilter, as_label_rows
from ..core.range_search import RangeConfig, RangeResult
from ..dist.sharded_engine import ShardedCorpus
from ..tier import TierFetchError
from .degraded import (
    DegradedResult,
    RetryPolicy,
    _corrupt_result,
    _search_one_shard,
    merge_shard_results,
    run_shard_workers,
    validate_shard_result,
)
from .errors import REPLICA_LOST, SHARD_LOST
from .injector import FaultInjector, ShardError, ShardFault, ShardTimeout


class ReplicaLost(ShardFault):
    """The targeted replica's data is gone (host down, rebuild pending)."""

    def __init__(self, shard: int, attempt: int, replica: int):
        super().__init__("replica_lost", shard, attempt, replica)


def _leaves(corpus: ShardedCorpus) -> List[torch.Tensor]:
    """The tensors a replica holds (the tiers' host stores are shared)."""
    p = corpus.points
    leaves = [p.codes, p.meta, p.raw] if isinstance(p, QuantizedCorpus) else [p]
    leaves += [corpus.neighbors, corpus.start_ids, corpus.offsets, corpus.labels]
    return [t for t in leaves if t is not None]


def _copy(corpus: ShardedCorpus) -> ShardedCorpus:
    """Fresh buffers for every tensor of ``corpus``; the tier views (the
    reference's static field) pass through shared."""
    p = corpus.points
    pts = (QuantizedCorpus(codes=p.codes.clone(), meta=p.meta.clone(),
                           raw=None if p.raw is None else p.raw.clone())
           if isinstance(p, QuantizedCorpus) else p.clone())
    return dataclasses.replace(
        corpus, points=pts, neighbors=corpus.neighbors.clone(),
        start_ids=corpus.start_ids.clone(), offsets=corpus.offsets.clone(),
        labels=None if corpus.labels is None else corpus.labels.clone())


@dataclasses.dataclass
class ReplicatedCorpus:
    """R bit-identical copies of a sharded corpus.

    Delegating properties expose replica 0's view, so anything that
    duck-types a ``ShardedCorpus`` (the server's dtype probe, label checks)
    works unchanged; by the parity invariant any replica would do."""

    replicas: List[ShardedCorpus]

    @staticmethod
    def replicate(corpus: ShardedCorpus, n: int) -> "ReplicatedCorpus":
        """``n`` bit-identical copies, each in fresh buffers (as distinct
        hosts would hold them)."""
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {n}")
        return ReplicatedCorpus(replicas=[corpus] + [_copy(corpus) for _ in range(n - 1)])

    def replica(self, r: int) -> ShardedCorpus:
        return self.replicas[r]

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def n_shards(self) -> int:
        return self.replicas[0].n_shards

    @property
    def shard_size(self) -> int:
        return self.replicas[0].shard_size

    @property
    def n_total(self) -> int:
        return self.replicas[0].n_total

    @property
    def offsets(self):
        return self.replicas[0].offsets

    @property
    def points(self):
        return self.replicas[0].points

    @property
    def labels(self):
        return self.replicas[0].labels

    def parity_ok(self) -> bool:
        """True iff every replica equals replica 0 bit for bit (compared on
        the device, tensor by tensor)."""
        base = _leaves(self.replicas[0])
        for rep in self.replicas[1:]:
            other = _leaves(rep)
            if len(other) != len(base) or not all(
                    a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(base, other)):
                return False
        return True


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Circuit-breaker tuning: trip after ``fail_threshold`` consecutive
    failures; after ``cooldown_s`` admit a single half-open probe."""

    fail_threshold: int = 3
    cooldown_s: float = 30.0


class CircuitBreaker:
    """Per-replica breaker: closed -> open (on consecutive failures) ->
    half-open (after the cooldown, one probe in flight) -> closed on the
    probe's success, open again on its failure. ``clock`` is injectable so
    tests drive the cooldown with a fake clock."""

    def __init__(self, cfg: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or BreakerConfig()
        self.clock = clock
        self.state = "closed"
        self.failures = 0       # consecutive, while closed
        self.opened_at = 0.0
        self.trips = 0
        self._probing = False   # a half-open probe is in flight

    def allow(self) -> bool:
        """May a request be sent to this replica now? Call only when a
        request WILL be sent on True: in half-open this takes the single
        probe slot, which only ``record_success`` / ``record_failure`` /
        ``release_probe`` give back."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self.clock() - self.opened_at < self.cfg.cooldown_s:
                return False
            self.state = "half_open"
            self._probing = False
        if self._probing:       # half-open: exactly one probe at a time
            return False
        self._probing = True
        return True

    def peek(self) -> bool:
        """Would ``allow()`` return True, without taking the probe slot or
        moving state? (Routing lookahead must not burn the probe.)"""
        if self.state == "closed":
            return True
        if self.state == "open":
            return self.clock() - self.opened_at >= self.cfg.cooldown_s
        return not self._probing

    def release_probe(self) -> None:
        """Give back an admitted but abandoned half-open probe (a hedged
        walk leaves a request it will never resolve)."""
        if self.state == "half_open":
            self._probing = False

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self._probing = False

    def record_failure(self) -> bool:
        """Record a failure; True iff the breaker tripped open now."""
        if self.state == "half_open":
            self._trip()  # a failed probe: straight back to open
            return True
        self.failures += 1
        if self.state == "closed" and self.failures >= self.cfg.fail_threshold:
            self._trip()
            return True
        return False

    def force_open(self) -> None:
        """Trip unconditionally (a replica declared lost out of band)."""
        if self.state != "open":
            self._trip()

    def to_half_open(self) -> None:
        """Skip the cooldown: the next ``allow()`` admits a probe (a rebuilt
        replica re-admitted by recovery)."""
        self.state = "half_open"
        self._probing = False
        self.failures = 0

    def _trip(self) -> None:
        self.state = "open"
        self.opened_at = self.clock()
        self.failures = 0
        self._probing = False
        self.trips += 1


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """When to fire a hedge at the next replica.

    ``delay_s`` pins a fixed delay; otherwise it derives from the shard's
    observed latencies: ``factor * hist.percentile(percentile)`` (p95 by
    default: hedges fire for the slowest ~5 % of primaries), at least
    ``min_delay_s``, and ``fallback_s`` until the histogram has samples."""

    delay_s: Optional[float] = None
    percentile: float = 95.0
    factor: float = 1.0
    min_delay_s: float = 1e-3
    fallback_s: float = 0.05

    def delay_for(self, hist) -> float:
        if self.delay_s is not None:
            return self.delay_s
        if hist is None or getattr(hist, "count", 0) == 0:
            return self.fallback_s
        return max(self.min_delay_s, self.factor * float(hist.percentile(self.percentile)))


class ReplicaFleet:
    """Control plane of an R-way replicated corpus.

    Tracks per-(shard, replica) availability and breakers, feeds per-shard
    latency histograms to the hedge policy, and recovers lost replicas
    (``maintain()``). Thread-safe: the fan-out's worker threads share it.

    ``recover_fn(shard, replica) -> bool`` customizes recovery (e.g. a live
    rebuild from a checkpoint and the WAL's tail); by default a replica is
    copied from a surviving peer, always possible while one replica of the
    shard lives, and always bit-identical, since replicas never diverge. A
    recovered replica re-enters through the breaker's half-open state, so
    its first request is a probe."""

    def __init__(self, corpus, *, breaker: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 recover_fn: Optional[Callable[[int, int], bool]] = None):
        if isinstance(corpus, ShardedCorpus):
            corpus = ReplicatedCorpus(replicas=[corpus])
        self.corpus: ReplicatedCorpus = corpus
        self.clock = clock
        self.breaker_cfg = breaker or BreakerConfig()
        self.recover_fn = recover_fn
        self.breakers: Dict[Tuple[int, int], CircuitBreaker] = {
            (s, rep): CircuitBreaker(self.breaker_cfg, clock)
            for s in range(self.n_shards) for rep in range(self.n_replicas)}
        self.lost: Set[Tuple[int, int]] = set()
        self._hists: List[Optional[object]] = [None] * self.n_shards
        self.stats: Dict[str, int] = {
            "hedges_fired": 0, "hedge_wins": 0, "breaker_trips": 0,
            "replicas_lost": 0, "replicas_recovered": 0}
        self._lock = threading.Lock()

    @property
    def n_shards(self) -> int:
        return self.corpus.n_shards

    @property
    def n_replicas(self) -> int:
        return self.corpus.n_replicas

    # -- routing ----------------------------------------------------------

    def order(self, shard: int, start: int) -> List[int]:
        """Live replicas of ``shard`` in rotation from ``start``: rotating by
        attempt spreads load and never re-primaries a replica that just
        failed."""
        n = self.n_replicas
        return [rep for rep in ((start + k) % n for k in range(n))
                if (shard, rep) not in self.lost]

    def allow(self, shard: int, replica: int) -> bool:
        """Admit a request that WILL be sent (takes a half-open probe)."""
        with self._lock:
            if (shard, replica) in self.lost:
                return False
            return self.breakers[(shard, replica)].allow()

    def would_allow(self, shard: int, replica: int) -> bool:
        """Admission check for routing lookahead, moving nothing."""
        with self._lock:
            if (shard, replica) in self.lost:
                return False
            return self.breakers[(shard, replica)].peek()

    def release(self, shard: int, replica: int) -> None:
        """Release an admitted half-open probe that will never resolve."""
        with self._lock:
            self.breakers[(shard, replica)].release_probe()

    def record_success(self, shard: int, replica: int) -> None:
        with self._lock:
            self.breakers[(shard, replica)].record_success()

    def record_failure(self, shard: int, replica: int) -> bool:
        with self._lock:
            tripped = self.breakers[(shard, replica)].record_failure()
            if tripped:
                self.stats["breaker_trips"] += 1
            return tripped

    def healthy(self, shard: int, replica: int) -> bool:
        """Not lost and not breaker-open (half-open counts: it is being
        probed back in)."""
        with self._lock:
            return ((shard, replica) not in self.lost
                    and self.breakers[(shard, replica)].state != "open")

    # -- latency / hedging ------------------------------------------------

    def hist(self, shard: int):
        h = self._hists[shard]
        if h is None:
            # a lazy import: repro_torch.serve imports repro_torch.fault
            from ..serve.latency import LatencyHistogram
            h = self._hists[shard] = LatencyHistogram()
        return h

    def record_latency(self, shard: int, seconds: float) -> None:
        with self._lock:
            self.hist(shard).record(seconds)

    def hedge_delay(self, shard: int, policy: HedgePolicy) -> float:
        with self._lock:
            return policy.delay_for(self._hists[shard])

    # -- loss & recovery --------------------------------------------------

    def lose(self, shard: int, replica: int) -> None:
        """Declare a replica's data gone (host died, disk lost). Searches
        skip it; ``maintain()`` rebuilds it."""
        with self._lock:
            if (shard, replica) in self.lost:
                return
            self.lost.add((shard, replica))
            self.stats["replicas_lost"] += 1
            self.breakers[(shard, replica)].force_open()

    def maintain(self) -> int:
        """Recovery sweep: rebuild each lost replica whose shard still has a
        surviving peer and re-admit it through the breaker's half-open
        probe. Returns the replicas recovered."""
        recovered = 0
        for shard, replica in sorted(self.lost):
            peers = [rep for rep in range(self.n_replicas)
                     if rep != replica and (shard, rep) not in self.lost]
            if not peers:
                continue  # nothing to rebuild from: the shard itself is lost
            if self.recover_fn is not None and not self.recover_fn(shard, replica):
                continue  # the rebuild is still in progress
            with self._lock:
                self.lost.discard((shard, replica))
                self.breakers[(shard, replica)].to_half_open()
                self.stats["replicas_recovered"] += 1
            recovered += 1
        return recovered

    def replica_ok_matrix(self) -> np.ndarray:
        """(S, R) bool: the replica is neither lost nor breaker-open."""
        return np.array([[self.healthy(s, rep) for rep in range(self.n_replicas)]
                         for s in range(self.n_shards)], bool)


@dataclasses.dataclass
class ReplicatedResult(DegradedResult):
    """A DegradedResult plus the batch's replica health.

    ``complete``/``coverage`` count *shards*: a shard is ok if ANY replica
    of it answered, so ``coverage < 1.0`` only when every replica of some
    shard was exhausted. ``code``: ``shard_lost`` beats ``replica_lost``
    beats ``None`` (healthy, full redundancy)."""

    replica_ok: np.ndarray   # (S, R) bool: healthy at merge time AND did not
    #                          fail unrecovered during this batch
    served_by: np.ndarray    # (S,) int32: the replica that answered, -1 if lost
    hedges_fired: int
    hedge_wins: int
    breaker_trips: int

    @property
    def replicas_total(self) -> int:
        return int(self.replica_ok.size)

    @property
    def replicas_ok(self) -> int:
        return int(self.replica_ok.sum())

    @property
    def code(self) -> Optional[str]:
        if not self.complete:
            return SHARD_LOST
        if self.replicas_ok < self.replicas_total:
            return REPLICA_LOST
        return None


@dataclasses.dataclass
class _ShardOutcome:
    ok: bool = False
    res: Optional[RangeResult] = None
    attempts: int = 0
    fault: Optional[str] = None
    served: int = -1
    hedges: int = 0
    wins: int = 0
    # replicas that failed during this batch and never succeeded after:
    # degraded redundancy even when a peer kept the answer whole
    rep_failed: Set[int] = dataclasses.field(default_factory=set)


def replicated_fan_out(
    *,
    fleet: ReplicaFleet,
    queries,
    r,
    cfg: RangeConfig,
    es_radius=None,
    tombstones=None,
    label_filter: Optional[LabelFilter] = None,
    injector: Optional[FaultInjector] = None,
    retry: Optional[RetryPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
    max_workers: Optional[int] = None,
    hedge: Optional[HedgePolicy] = None,
    preferred: int = 0,
) -> ReplicatedResult:
    """Replicated fault-tolerant range search (one worker thread a shard).

    Per shard and retry attempt: walk the live, breaker-admitted replicas in
    rotation (primary first). A timeout, error or garbage fails over to the
    next replica at once and counts against that replica's breaker; a
    scripted-``slow`` primary is *hedged*: left for the next replica with no
    breaker penalty (slow is not sick). The first answer that passes
    :func:`~repro_torch.fault.degraded.validate_shard_result` wins; by the
    parity invariant the winner's identity is unobservable in the merge.

    With no injector, hedging is wall-clock: the primary runs in a pool of
    its own and the hedge fires after ``hedge.delay_for(the shard's
    histogram)`` seconds; the first validated answer wins. A losing request
    cannot be cancelled once it runs: it finishes in its thread (its
    latency goes to the histogram) and its result is dropped.

    The merge is ``merge_shard_results`` in shard order, on the queries'
    device: bit for bit the single-replica serial search restricted to the
    surviving shards."""
    retry = retry or RetryPolicy()
    corpus0 = fleet.corpus.replica(0)
    if corpus0.n_local != corpus0.n_shards:
        raise ValueError(
            f"the host fan-out needs every shard; this corpus holds {corpus0.n_local} of "
            f"{corpus0.n_shards} (built for a mesh)")
    if label_filter is not None and corpus0.labels is None:
        raise ValueError("corpus has no labels attached; build_sharded(..., labels=) "
                         "to use filtered range search")
    dev = corpus0.device
    queries = torch.as_tensor(queries).to(device=dev, dtype=torch.float32)
    n_q = queries.shape[0]
    radii = broadcast_radius(r, n_q, device=dev)
    es_vec = broadcast_radius(es_radius, n_q, device=dev)
    if label_filter is not None:
        label_filter = label_filter.to(dev)
    if tombstones is not None:
        tombstones = as_label_rows(tombstones, dev)   # (S, W) int32 words
    radii_np = radii.cpu().numpy()
    s_total = fleet.n_shards
    rows = fleet.corpus.shard_size
    offsets_np = fleet.corpus.offsets.cpu().numpy()
    # wall-clock hedges race primary against hedge in a small pool of their
    # own; scripted ("slow") hedges are deterministic and need no timer
    wall_clock_hedge = hedge is not None and injector is None and fleet.n_replicas > 1
    hedge_pool = ThreadPoolExecutor(
        max_workers=min(32, max(2, s_total * 2))) if wall_clock_hedge else None

    def search_replica(s: int, rep: int, offset: int, attempt: int,
                       kind: Optional[str]) -> RangeResult:
        """One (shard, replica) try: search, maybe corrupt, validate."""
        t0 = time.perf_counter()
        res = _search_one_shard(fleet.corpus.replica(rep), s, queries, radii, cfg, es_vec,
                                tombstones, label_filter)
        if kind == "garbage":
            res = _corrupt_result(res, injector.rng(s, attempt, rep))
        if not validate_shard_result(res, offset, rows, corpus0.n_total, radii_np,
                                     atol=retry.atol, rtol=retry.rtol):
            raise ShardFault("garbage", s, attempt, rep)
        fleet.record_latency(s, time.perf_counter() - t0)
        return res

    def walk_scripted(st: _ShardOutcome, s: int, offset: int, attempt: int,
                      order: Sequence[int]) -> bool:
        """Deterministic walk: failover and scripted-slow hedging. Admission
        happens at contact: ``allow()`` takes a half-open probe, so it runs
        only for replicas the walk reaches."""
        pending_hedge = False
        for k, rep in enumerate(order):
            if not fleet.allow(s, rep):
                continue
            kind = injector.fault_for(s, attempt, rep) if injector is not None else None
            if kind == "slow":
                if hedge is not None and any(fleet.would_allow(s, nxt)
                                             for nxt in order[k + 1:]):
                    # the primary is past the hedge deadline: fire the next
                    # replica. Slow is no failure: no breaker penalty (the
                    # abandoned request's probe is released), and its late
                    # answer, identical by parity, loses the race
                    st.hedges += 1
                    pending_hedge = True
                    fleet.release(s, rep)
                    continue
                kind = None  # nothing to hedge to: just a late success
            try:
                if kind == "timeout":
                    raise ShardTimeout(s, attempt, rep)
                if kind == "error":
                    raise ShardError(s, attempt, rep)
                res = search_replica(s, rep, offset, attempt, kind)
            except (ShardFault, TierFetchError) as e:
                st.fault = getattr(e, "kind", "tier_fetch")
                st.rep_failed.add(rep)
                fleet.record_failure(s, rep)
                continue
            fleet.record_success(s, rep)
            st.rep_failed.discard(rep)
            if pending_hedge:
                st.wins += 1
            st.ok, st.res, st.served = True, res, rep
            return True
        return False

    def walk_timed(st: _ShardOutcome, s: int, offset: int, attempt: int,
                   order: Sequence[int]) -> bool:
        """Wall-clock walk: primary against hedges, the first validated
        answer wins. Replicas are admitted as they are submitted, and every
        submitted request resolves its probe through ``record_success`` /
        ``record_failure``."""
        delay = fleet.hedge_delay(s, hedge)
        futs: Dict[object, int] = {}
        next_k = 0

        def submit_next() -> Optional[int]:
            nonlocal next_k
            while next_k < len(order):
                rep = order[next_k]
                next_k += 1
                if fleet.allow(s, rep):
                    futs[hedge_pool.submit(search_replica, s, rep, offset, attempt,
                                           None)] = rep
                    return rep
            return None

        primary = submit_next()
        while futs:
            # with every replica in flight there is nothing left to hedge
            # to: block until one answers (the reference polls at ``delay``,
            # which on the CPU spins the interpreter lock away from the
            # searching threads)
            done, _ = wait(futs, timeout=delay if next_k < len(order) else None,
                           return_when=FIRST_COMPLETED)
            if not done and next_k < len(order):
                if submit_next() is not None:
                    st.hedges += 1
                continue
            if not done:
                continue  # every hedge in flight: keep waiting
            fut = next(iter(done))
            rep = futs.pop(fut)
            try:
                res = fut.result()
            except (ShardFault, TierFetchError) as e:
                st.fault = getattr(e, "kind", "tier_fetch")
                st.rep_failed.add(rep)
                fleet.record_failure(s, rep)
                if not futs:
                    submit_next()  # failover, not a hedge
                continue
            fleet.record_success(s, rep)
            st.rep_failed.discard(rep)
            if rep != primary:
                st.wins += 1
            st.ok, st.res, st.served = True, res, rep
            for f in futs:  # late answers are identical by parity: drop them
                f.cancel()
            return True
        return False

    def run_shard(s: int) -> _ShardOutcome:
        offset = int(offsets_np[s])
        st = _ShardOutcome()
        for attempt in range(retry.max_attempts):
            st.attempts += 1
            order = fleet.order(s, preferred + attempt)
            if order:
                walk = walk_timed if wall_clock_hedge else walk_scripted
                if walk(st, s, offset, attempt, order):
                    return st
            if attempt + 1 < retry.max_attempts:
                d = retry.delay_s(attempt, key=s)
                if d > 0:
                    sleep(d)
        return st

    try:
        outcomes: List[_ShardOutcome] = run_shard_workers(run_shard, s_total, max_workers)
    finally:
        if hedge_pool is not None:
            hedge_pool.shutdown(wait=False)

    shard_ok = np.array([st.ok for st in outcomes], bool)
    attempts = np.array([st.attempts for st in outcomes], np.int32)
    faults = [st.fault for st in outcomes]
    per_shard = [st.res for st in outcomes]
    hedges = sum(st.hedges for st in outcomes)
    wins = sum(st.wins for st in outcomes)
    with fleet._lock:
        fleet.stats["hedges_fired"] += hedges
        fleet.stats["hedge_wins"] += wins
        trips_total = fleet.stats["breaker_trips"]

    replica_ok = fleet.replica_ok_matrix()
    for s, st in enumerate(outcomes):
        for rep in st.rep_failed:
            replica_ok[s, rep] = False

    merged = merge_shard_results(per_shard, shard_ok, n_q, cfg.result_cap, device=dev)
    return ReplicatedResult(
        result=merged, shard_ok=shard_ok, attempts=attempts, faults=faults,
        replica_ok=replica_ok,
        served_by=np.array([st.served for st in outcomes], np.int32),
        hedges_fired=hedges, hedge_wins=wins, breaker_trips=trips_total)
