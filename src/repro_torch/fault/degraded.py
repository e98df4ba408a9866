"""Fault-tolerant sharded range search: host fan-out with degradation.

The collective path (``dist.sharded_range_search``) assumes every shard
answers; one collective program completes or fails as a unit. This module
is the serving-side alternative: shards are searched independently from the
host, concurrently (one worker thread per shard, every thread issuing onto
the same device), so a shard that times out, errors or returns garbage
degrades the answer instead of destroying it.

Per shard: retry with jittered, capped exponential backoff for transient
faults, validate every answer on the host against invariants no honest
shard can violate (ids inside the shard's global range, finite in-radius
distances, consistent counts), and on exhaustion mark the shard lost in a
validity mask. The union merge runs over surviving shards only, **in shard
order** whatever order the threads finish in, so the merged result is bit
for bit independent of scheduling. Because the shards partition the corpus
and each per-shard search is deterministic, the merged result over
surviving shards equals a healthy run restricted to those shards:
degradation truncates coverage, never corrupts results.

With replication (``fleet=``, see :mod:`repro_torch.fault.replica`) the
per-shard worker also fails over across replicas, hedges slow primaries
and respects per-replica circuit breakers; a shard is lost only when
*every* replica of it is exhausted.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.beam_search import broadcast_radius
from ..core.labels import LabelFilter, as_label_rows
from ..core.range_search import RangeConfig, RangeResult
from ..dist.sharded_engine import ShardedCorpus, _shard_result, union_merge
from ..tier import TierFetchError
from ..utils import INVALID_ID
from .errors import SHARD_LOST
from .injector import FaultInjector, ShardFault


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Transient-fault retry: ``max_attempts`` tries per shard, sleeping
    ``min(backoff_s * backoff_factor**attempt, backoff_max_s)`` between
    them (``backoff_s=0``: no sleep, the setting for scripted faults).
    ``jitter > 0`` stretches each delay by a uniform factor in
    ``[1, 1 + jitter]`` drawn from a counter-based seeded stream (key
    ``[seed, shard, attempt]``), so retries across shards de-synchronize
    deterministically; the default ``jitter=0.0`` keeps delays exact.

    Also carries the result-validation tolerances used by
    :func:`validate_shard_result` on this path: a distance is in radius up
    to ``atol + rtol * r`` (float error scales with the radius)."""

    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 5.0
    jitter: float = 0.0
    seed: int = 0
    atol: float = 1e-4
    rtol: float = 1e-5

    def delay_s(self, attempt: int, key: int = 0) -> float:
        """Backoff before retrying ``attempt`` (0-based), for shard ``key``."""
        d = min(self.backoff_s * self.backoff_factor ** attempt, self.backoff_max_s)
        if self.jitter > 0.0 and d > 0.0:
            u = float(np.random.default_rng([int(self.seed), int(key), int(attempt)]).random())
            d *= 1.0 + self.jitter * u
        return d


@dataclasses.dataclass
class DegradedResult:
    """A merged RangeResult plus the per-shard health that produced it."""

    result: RangeResult
    shard_ok: np.ndarray         # (S,) bool: the shard's results are in the merge
    attempts: np.ndarray         # (S,) int32: search attempts per shard
    faults: List[Optional[str]]  # last injected/observed fault kind per shard

    @property
    def shards_total(self) -> int:
        return int(self.shard_ok.shape[0])

    @property
    def shards_ok(self) -> int:
        return int(self.shard_ok.sum())

    @property
    def complete(self) -> bool:
        return self.shards_ok == self.shards_total

    @property
    def coverage(self) -> float:
        """Fraction of shards in the merge (3/4 when one of four is lost)."""
        return self.shards_ok / max(1, self.shards_total)

    @property
    def code(self) -> Optional[str]:
        return None if self.complete else SHARD_LOST


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def validate_shard_result(res: RangeResult, offset: int, shard_rows: int, n_total: int,
                          radii, atol: float = 1e-4, rtol: float = 0.0) -> bool:
    """Invariants no honest shard can violate (``res`` already global-id),
    checked on the host:

    - every valid id lies inside the shard's global row range and the corpus;
    - every valid distance is finite, non-negative, and within the lane's
      radius up to ``atol + rtol * r``;
    - per-lane counts never exceed the result buffer.

    A shard returning garbage fails here and is retried like any other
    transient fault: the merge never trusts an unvalidated answer."""
    ids = _host(res.ids)
    dists = _host(res.dists)
    valid = ids != INVALID_ID
    lo, hi = int(offset), min(int(offset) + int(shard_rows), int(n_total))
    if np.any(valid & ((ids < lo) | (ids >= hi))):
        return False
    d = np.where(valid, dists, 0.0)
    if not np.all(np.isfinite(d)) or np.any(d < 0):
        return False
    r = np.asarray(_host(radii), np.float32).reshape(-1, 1)
    if np.any(valid & (dists > r + (atol + rtol * r))):
        return False
    if np.any(_host(res.count) > ids.shape[1]):
        return False
    return True


def _corrupt_result(res: RangeResult, rng: np.random.Generator) -> RangeResult:
    """Garble a result the way a sick shard would, from the injector's numpy
    stream (the reference's draws, so the same entries): random
    out-of-range ids plus a negative distance, so validation must catch it."""
    shape = tuple(res.ids.shape)
    ids = rng.integers(0, 2**31 - 2, size=shape, dtype=np.int32)
    dists = rng.uniform(-1.0, 1.0, size=tuple(res.dists.shape)).astype(np.float32)
    dists[:, 0] = -1.0  # a negative distance is never valid
    dev = res.ids.device
    return dataclasses.replace(
        res, ids=torch.from_numpy(ids).to(dev), dists=torch.from_numpy(dists).to(dev),
        count=torch.full_like(res.count, shape[1]))


def _search_one_shard(corpus: ShardedCorpus, s: int, queries, radii, cfg, es_vec,
                      tombstones, label_filter: Optional[LabelFilter] = None) -> RangeResult:
    """Shard ``s``'s exact search with its ids remapped to global: the same
    per-shard program the collective path runs, minus the mesh."""
    return _shard_result(corpus, s - corpus.first_shard, queries, radii, cfg, es_vec,
                         tombstones, label_filter)


def merge_shard_results(per_shard: List[Optional[RangeResult]], shard_ok: np.ndarray,
                        n_q: int, cap: int, *, device=None) -> RangeResult:
    """Union-merge surviving shards' results, in shard order: a pure function
    of the surviving results and their order, never of which thread produced
    them. ``device`` places an empty merge (every shard lost); otherwise the
    merge stays on the results' device."""
    ok = [per_shard[s] for s in range(len(per_shard)) if shard_ok[s]]
    if not ok:  # every shard lost: an empty (but well-formed) result
        dev = torch.device("cpu") if device is None else torch.device(device)

        def zeros(dtype):
            return torch.zeros(n_q, dtype=dtype, device=dev)

        return RangeResult(
            ids=torch.full((n_q, cap), INVALID_ID, dtype=torch.int32, device=dev),
            dists=torch.full((n_q, cap), float("inf"), dtype=torch.float32, device=dev),
            count=zeros(torch.int32), overflow=zeros(torch.bool),
            n_visited=zeros(torch.int32), n_dist=zeros(torch.int32),
            es_stopped=zeros(torch.bool), phase2=zeros(torch.bool),
            n_rerank=zeros(torch.int32))
    ids = torch.cat([p.ids for p in ok], dim=1)
    dists = torch.cat([p.dists for p in ok], dim=1)
    if ids.shape[1] < cap:  # fewer candidates than the cap: pad the merge
        pad = cap - ids.shape[1]
        ids = torch.cat([ids, torch.full((n_q, pad), INVALID_ID, dtype=ids.dtype,
                                         device=ids.device)], dim=1)
        dists = torch.cat([dists, torch.full((n_q, pad), float("inf"), dtype=dists.dtype,
                                             device=dists.device)], dim=1)
    ids, dists = union_merge(ids, dists, cap)
    total = sum(p.count for p in ok)
    return RangeResult(
        ids=ids, dists=dists,
        count=torch.minimum(total, torch.full_like(total, cap)).to(torch.int32),
        overflow=(sum(p.overflow.to(torch.int32) for p in ok) > 0) | (total > cap),
        n_visited=sum(p.n_visited for p in ok),
        n_dist=sum(p.n_dist for p in ok),
        es_stopped=sum(p.es_stopped.to(torch.int32) for p in ok) > 0,
        phase2=sum(p.phase2.to(torch.int32) for p in ok) > 0,
        n_rerank=sum(p.n_rerank for p in ok))


def run_shard_workers(fn: Callable[[int], object], s_total: int,
                      max_workers: Optional[int]) -> List[object]:
    """Run ``fn(s)`` for every shard, returning outcomes indexed by shard.
    ``max_workers=None`` sizes the pool to the shard count; ``0`` runs
    serially on the calling thread (the reference path the threaded fan-out
    is held to)."""
    if max_workers is None:
        max_workers = s_total
    if max_workers <= 0 or s_total <= 1:
        return [fn(s) for s in range(s_total)]
    with ThreadPoolExecutor(max_workers=min(max_workers, s_total)) as pool:
        return list(pool.map(fn, range(s_total)))


def fault_tolerant_sharded_search(
    *,
    corpus: Optional[ShardedCorpus] = None,
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
    fleet=None,
    hedge=None,
) -> DegradedResult:
    """Union range search over ``corpus`` (holding every shard) that
    survives shard loss.

    Shards are searched concurrently (one worker thread per shard;
    ``max_workers=0`` forces the serial path). Injected or observed faults
    retry up to ``retry.max_attempts`` with jittered, capped exponential
    backoff; answers are validated before they may join the merge, and a
    shard that exhausts its retries is marked lost rather than failing the
    query. A failed host-store fetch of a tiered shard (``TierFetchError``)
    degrades the same way. The returned :class:`DegradedResult` carries the
    merged global ``RangeResult`` over surviving shards plus the per-shard
    validity mask and attempt counts.

    With every shard healthy the merge equals the collective
    ``sharded_range_search`` (same per-shard program, same union merge);
    with shards lost it equals that merge restricted to the survivors. The
    threaded fan-out merges in shard order, so it equals the serial loop bit
    for bit under every fault script.

    With ``fleet=`` (a :class:`~repro_torch.fault.replica.ReplicaFleet`)
    the search runs replicated: per-shard failover across R bit-identical
    replicas, hedging of slow primaries (``hedge=``, a
    :class:`~repro_torch.fault.replica.HedgePolicy`) and per-replica circuit
    breakers; ``corpus`` is then taken from the fleet and the result is a
    :class:`~repro_torch.fault.replica.ReplicatedResult`. Without a fleet
    ``hedge`` has nothing to hedge to and is ignored."""
    if fleet is not None:
        from .replica import replicated_fan_out
        return replicated_fan_out(
            fleet=fleet, queries=queries, r=r, cfg=cfg, es_radius=es_radius,
            tombstones=tombstones, label_filter=label_filter, injector=injector,
            retry=retry, sleep=sleep, max_workers=max_workers, hedge=hedge)
    if corpus is None:
        raise ValueError("pass corpus= (or fleet= for replicated search)")
    if corpus.n_local != corpus.n_shards:
        raise ValueError(
            f"the host fan-out needs every shard; this corpus holds {corpus.n_local} of "
            f"{corpus.n_shards} (built for a mesh)")
    retry = retry or RetryPolicy()
    if label_filter is not None and corpus.labels is None:
        raise ValueError("corpus has no labels attached; build_sharded(..., labels=) "
                         "to use filtered range search")
    dev = corpus.device
    queries = torch.as_tensor(queries).to(device=dev, dtype=torch.float32)
    n_q = queries.shape[0]
    radii = broadcast_radius(r, n_q, device=dev)
    es_vec = broadcast_radius(es_radius, n_q, device=dev)
    if label_filter is not None:
        label_filter = label_filter.to(dev)
    if tombstones is not None:
        tombstones = as_label_rows(tombstones, dev)   # (S, W) int32 words
    radii_np = radii.cpu().numpy()
    s_total = corpus.n_shards
    rows = corpus.shard_size
    offsets_np = corpus.offsets.cpu().numpy()

    def run_shard(s: int):
        """One shard's retry loop; returns (ok, result, attempts, fault)."""
        offset = int(offsets_np[s])
        fault: Optional[str] = None
        for attempt in range(retry.max_attempts):
            try:
                kind = (injector.raise_if_faulted(s, attempt)
                        if injector is not None else None)
                res = _search_one_shard(corpus, s, queries, radii, cfg, es_vec,
                                        tombstones, label_filter)
                if kind == "garbage":
                    res = _corrupt_result(res, injector.rng(s, attempt))
                if not validate_shard_result(res, offset, rows, corpus.n_total, radii_np,
                                             atol=retry.atol, rtol=retry.rtol):
                    fault = "garbage"
                    raise ShardFault("garbage", s, attempt)
                return True, res, attempt + 1, fault
            except (ShardFault, TierFetchError) as e:
                # a failed host-store fetch degrades exactly like a lost
                # shard: retry, then annotate; never crash the batch
                fault = getattr(e, "kind", "tier_fetch")
                if attempt + 1 < retry.max_attempts:
                    d = retry.delay_s(attempt, key=s)
                    if d > 0:
                        sleep(d)
        return False, None, retry.max_attempts, fault

    outcomes = run_shard_workers(run_shard, s_total, max_workers)

    shard_ok = np.zeros(s_total, bool)
    attempts = np.zeros(s_total, np.int32)
    faults: List[Optional[str]] = [None] * s_total
    per_shard: List[Optional[RangeResult]] = [None] * s_total
    for s, (ok, res, n_att, fault) in enumerate(outcomes):
        shard_ok[s] = ok
        per_shard[s] = res
        attempts[s] = n_att
        faults[s] = fault

    merged = merge_shard_results(per_shard, shard_ok, n_q, cfg.result_cap, device=dev)
    return DegradedResult(result=merged, shard_ok=shard_ok, attempts=attempts, faults=faults)
