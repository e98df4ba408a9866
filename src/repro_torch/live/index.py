"""LiveIndex: a mutable range-retrieval index over a pre-allocated capacity.

The engine assumes a frozen Vamana graph; the paper's applications
(duplicate detection, facial recognition) churn. This module makes the
index mutable over the same search code:

* **Capacity and watermark.** The corpus and adjacency are allocated at a
  fixed ``capacity``; ``live_count`` is the high-water mark. Rows past it
  are unreachable sentinels (no in-edges, ``FAR`` coordinates).
* **Streaming inserts** reuse the build's ``core.build.insert_batch_step``
  (beam search, RobustPrune, reverse edges with overflow pruning), one step
  per ``insert_batch`` rows. New rows are written behind the watermark
  first (quantized on the way in for an int8 corpus, each with its exact
  ``err``), then wired into the graph. External ids are assigned
  monotonically and survive consolidation; slots are internal.
* **Labels** (optional) live in a capacity-sized packed (N_cap, W) store
  beside the corpus (int32 words holding the reference's uint32 bits):
  inserts carry label rows (through the WAL with the vectors),
  consolidation moves them with their slots, snapshots take ``filter=``.
* **Lazy deletes** set bits in an exact tombstone bitset over the
  capacity. Deleted nodes keep their vectors and edges, so the walk routes
  through them (FreshDiskANN semantics), and the result stage drops them.
* **Consolidation** (``live.consolidate``) rewires around tombstones and
  compacts the live rows to the front once the tombstone fraction crosses
  ``LiveConfig.consolidate_at``.
* **Snapshots.** Every mutation makes new tensors and writes nothing in
  place into a tensor a snapshot may hold (the corpus helpers copy, the
  tombstones are cloned before their bits are set, label rows likewise,
  ``insert_batch_step`` returns a new adjacency), so a ``snapshot()`` stays
  valid and unchanged however the index mutates afterwards. The one write
  in place is the tier's host store, into fresh slots past every published
  snapshot's watermark.
* **Durability.** With a ``fault.WriteAheadLog`` attached, each public
  mutation logs one checksummed record after its validation and before
  any state changes; ``save`` writes a checkpoint in the reference's
  layout and dtypes (interchangeable with the JAX package's), and
  ``restore(..., wal=)`` replays the log's tail through the public
  mutation path. Every mutation is deterministic, on the card too, so the
  recovered state equals the uninterrupted one bit for bit.

The index's tensors live on one device, the card unless ``create`` or
``restore`` is asked for the CPU. The host keeps what the tensors cannot
answer in O(1): the ``ext -> slot`` map and the dead-slot set.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.beam_search import SearchConfig, broadcast_radius
from ..core.bitset import bitset_add, bitset_contains
from ..core.build import BuildConfig, build_vamana, insert_batch_step
from ..core.corpus import (
    Corpus, QuantizedCorpus, corpus_cast, corpus_dtype_name, corpus_raw, corpus_set_rows,
    corpus_with_capacity, hot_arm)
from ..core.engine import RangeSearchEngine
from ..core.graph import Graph, start_points
from ..core.labels import as_label_rows
from ..core.range_search import (
    RangeConfig, RangeResult, range_search_compacted, range_search_fused)
from ..utils import INVALID_ID, cdiv, resolve_device
from .consolidate import consolidate_index

# Sentinel coordinate of unborn rows.
FAR = 1e30


def externalize_ids(ext_ids: np.ndarray, ids) -> np.ndarray:
    """Map a result buffer of slot ids (numpy or a tensor) to external ids
    (int64; INVALID passes through)."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    ids = np.asarray(ids)
    valid = ids != INVALID_ID
    return np.where(valid, np.asarray(ext_ids)[np.where(valid, ids, 0)],
                    np.int64(INVALID_ID)).astype(np.int64)


def _host_words(t: torch.Tensor) -> np.ndarray:
    """Packed int32 words as the reference's uint32 array (host)."""
    return t.cpu().numpy().view(np.uint32)


@dataclasses.dataclass(frozen=True)
class LiveConfig:
    """Static configuration of a live index."""

    capacity: int                 # N_cap: pre-allocated corpus rows
    insert_batch: int = 128       # rows per insert step
    consolidate_at: float = 0.25  # tombstone fraction that triggers rewiring
    n_starts: int = 4             # search entry points

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        if self.insert_batch < 1:
            raise ValueError("insert_batch must be >= 1")
        if not (0.0 < self.consolidate_at <= 1.0):
            raise ValueError("consolidate_at must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class LiveSnapshot:
    """An immutable, consistent view of the index at one epoch: search it
    and the answer is coherent however the owning ``LiveIndex`` mutates
    afterwards."""

    points: Corpus            # (N_cap, d) corpus (rows past the watermark: FAR)
    graph: Graph              # (N_cap, R) adjacency
    start_ids: torch.Tensor   # (S,) entry slots
    tombstones: torch.Tensor  # (W,) int32 words: exact dead-slot bitset
    ext_ids: np.ndarray       # (N_cap,) int64 slot -> external id (host)
    live_count: int           # watermark (born slots, tombstoned included)
    n_dead: int               # tombstoned slots
    epoch: int
    metric: str
    # (N_cap, W) int32 packed label rows, or None (unlabeled); unborn and
    # reclaimed slots carry zero rows
    labels: Optional[torch.Tensor] = None

    @property
    def n_live(self) -> int:
        return self.live_count - self.n_dead

    @property
    def device(self) -> torch.device:
        return hot_arm(self.points).device

    def range(self, queries, r, *, cfg: Optional[RangeConfig] = None,
              es_radius=None, compacted: bool = True, filter=None) -> RangeResult:
        """Range search over the live set. The returned ``ids`` are EXTERNAL
        ids (int64, INVALID padded); the rest is the engine's result.
        Tombstoned slots still route the walk and unborn slots are
        unreachable. ``filter`` is a per-query ``core.labels.LabelFilter``
        over the snapshot's labels."""
        cfg = cfg or RangeConfig(search=SearchConfig(metric=self.metric))
        if cfg.search.metric != self.metric:
            cfg = dataclasses.replace(cfg, search=dataclasses.replace(
                cfg.search, metric=self.metric))
        if filter is not None and self.labels is None:
            raise ValueError(
                "snapshot has no labels attached; create the LiveIndex with "
                "labels= to use filtered range search")
        dev = self.device
        q = torch.as_tensor(queries).to(device=dev, dtype=torch.float32).contiguous()
        n = q.shape[0]
        fn = range_search_compacted if compacted else range_search_fused
        res = fn(corpus=self.points, graph=self.graph, queries=q, start_ids=self.start_ids,
                 r=broadcast_radius(r, n, device=dev), cfg=cfg,
                 es_radius=None if es_radius is None else broadcast_radius(es_radius, n,
                                                                           device=dev),
                 tombstones=self.tombstones,
                 labels=None if filter is None else self.labels,
                 label_filter=None if filter is None else filter.to(dev))
        return self._externalize(res)

    def _externalize(self, res: RangeResult) -> RangeResult:
        ext = torch.from_numpy(externalize_ids(self.ext_ids, res.ids))
        return dataclasses.replace(res, ids=ext.to(res.ids.device))

    def as_engine(self) -> RangeSearchEngine:
        """Slot-id engine view (introspection): its queries see slot ids and
        no tombstone filter; use ``range``."""
        return RangeSearchEngine(points=self.points, graph=self.graph,
                                 start_ids=self.start_ids, labels=self.labels,
                                 metric=self.metric)


class LiveIndex:
    """Mutable wrapper around the engine's tensors (a host orchestrator)."""

    def __init__(self, *, points: Corpus, neighbors: torch.Tensor,
                 start_ids: torch.Tensor, ext_ids: np.ndarray,
                 tombstones: torch.Tensor, live_count: int, next_ext_id: int,
                 epoch: int, metric: str, build_cfg: BuildConfig,
                 cfg: LiveConfig, dead_slots: Optional[set] = None,
                 labels: Optional[torch.Tensor] = None):
        self.points = points
        self.labels = labels
        self.neighbors = neighbors
        self.start_ids = start_ids
        self.ext_ids = ext_ids
        self.tombstones = tombstones
        self.live_count = int(live_count)
        self.next_ext_id = int(next_ext_id)
        self.epoch = int(epoch)
        self.metric = metric
        self.build_cfg = build_cfg
        self.cfg = cfg
        self._dead: set[int] = set() if dead_slots is None else set(dead_slots)
        born = ext_ids[:self.live_count]
        keep = born != INVALID_ID
        self._slot_of: dict[int, int] = dict(zip(born[keep].tolist(),
                                                 np.nonzero(keep)[0].tolist()))
        # crash safety (fault.wal): with a WAL attached every public mutation
        # logs one record BEFORE it applies. wal_seq is the mutation sequence
        # number, distinct from epoch (which an insert's internal
        # consolidation advances too); _replaying / _suppress_log stop the
        # re-logging of replayed records and of insert-internal
        # consolidations (replaying the insert reproduces them)
        self.wal = None
        self.wal_seq = 0
        self._replaying = False
        self._suppress_log = False

    @property
    def device(self) -> torch.device:
        return hot_arm(self.points).device

    # -- write-ahead log -----------------------------------------------------
    def attach_wal(self, wal) -> None:
        """Log every later mutation to ``wal`` (a ``fault.WriteAheadLog``)
        before it applies. A torn tail from a crash is truncated first, and
        ``wal_seq`` resumes past the log's last record."""
        wal.truncate_torn_tail()
        self.wal = wal
        self.wal_seq = max(self.wal_seq, wal.last_seq)

    def _log(self, op: str, arrays: Optional[dict] = None) -> None:
        if self.wal is None or self._replaying or self._suppress_log:
            return
        self.wal_seq += 1
        self.wal.append(self.wal_seq, op, arrays or {})

    def _apply_record(self, rec) -> None:
        """Replay one WAL record through the public mutation path."""
        if rec.op == "insert":
            self.insert(rec.arrays["vecs"], ext_ids=rec.arrays["ext_ids"],
                        labels=rec.arrays.get("labels"))
        elif rec.op == "delete":
            self.delete(rec.arrays["ext_ids"])
        elif rec.op == "consolidate":
            self.consolidate()
        else:
            raise ValueError(f"unknown WAL op {rec.op!r}")

    # -- construction --------------------------------------------------------
    @staticmethod
    def create(points, cfg: LiveConfig, build_cfg: Optional[BuildConfig] = None,
               metric: str = "l2", corpus_dtype: str = "float32", seed: int = 0,
               first_ext_id: int = 0, graph: Optional[Graph] = None, labels=None,
               tier: bool = False, resident_mb: Optional[float] = None,
               device="cuda") -> "LiveIndex":
        """Build the initial frozen index on ``device``, then allocate it to
        capacity. ``graph`` skips the Vamana build and promotes an existing
        graph (built on these exact points). ``first_ext_id`` offsets the
        external ids. ``labels`` is the (n0, W) packed label matrix
        (``core.labels.pack_labels``) of the initial rows. ``tier=True``
        keeps the raw rows, the unborn sentinels' included, in a host row
        store that inserts write through and consolidation compacts;
        ``resident_mb`` caps its device row cache."""
        dev = resolve_device(device)
        pts = torch.as_tensor(points).to(device=dev, dtype=torch.float32).contiguous()
        n0 = pts.shape[0]
        if n0 > cfg.capacity:
            raise ValueError(f"initial corpus {n0} exceeds capacity {cfg.capacity}")
        bcfg = build_cfg or BuildConfig(metric=metric)
        if graph is None:
            graph = build_vamana(pts, bcfg, seed=seed, device=dev)
        elif graph.num_nodes != n0:
            raise ValueError("graph was not built on these points")
        starts = start_points(pts, metric, cfg.n_starts)
        stored = corpus_with_capacity(corpus_cast(pts, corpus_dtype), cfg.capacity, FAR)
        if corpus_dtype == "int8":
            corpus_raw(stored)  # a live int8 corpus needs its raw rows
        if tier:
            from ..tier import tiered_corpus  # live stays importable without tier
            stored = tiered_corpus(stored, corpus_dtype=corpus_dtype,
                                   resident_mb=resident_mb, device=dev)
        g = torch.as_tensor(graph.neighbors).to(device=dev, dtype=torch.int32)
        nbrs = torch.cat([g, torch.full((cfg.capacity - n0, g.shape[1]), INVALID_ID,
                                        dtype=torch.int32, device=dev)])
        ext = np.full(cfg.capacity, INVALID_ID, np.int64)
        ext[:n0] = first_ext_id + np.arange(n0)
        lab = None
        if labels is not None:
            labels = as_label_rows(labels, dev)
            if labels.shape[0] != n0:
                raise ValueError(f"labels rows ({labels.shape[0]}) != initial corpus "
                                 f"size ({n0})")
            lab = torch.zeros((cfg.capacity, labels.shape[1]), dtype=torch.int32, device=dev)
            lab[:n0] = labels
        return LiveIndex(
            points=stored, neighbors=nbrs, start_ids=starts, ext_ids=ext,
            tombstones=torch.zeros((cdiv(cfg.capacity, 32),), dtype=torch.int32, device=dev),
            live_count=n0, next_ext_id=first_ext_id + n0, epoch=0,
            metric=metric, build_cfg=bcfg, cfg=cfg, labels=lab)

    # -- introspection -------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.cfg.capacity

    @property
    def n_dead(self) -> int:
        return len(self._dead)

    @property
    def n_live(self) -> int:
        return self.live_count - self.n_dead

    @property
    def free_slots(self) -> int:
        return self.capacity - self.live_count

    def tombstone_frac(self) -> float:
        return self.n_dead / max(self.live_count, 1)

    def corpus_dtype(self) -> str:
        return corpus_dtype_name(self.points)

    def stats(self) -> dict:
        return dict(capacity=self.capacity, live_count=self.live_count,
                    n_live=self.n_live, n_dead=self.n_dead,
                    free_slots=self.free_slots, epoch=self.epoch,
                    tombstone_frac=round(self.tombstone_frac(), 4),
                    metric=self.metric, corpus_dtype=self.corpus_dtype())

    def _live_slots(self) -> np.ndarray:
        live = np.ones(self.live_count, bool)
        if self._dead:
            live[np.fromiter(self._dead, np.int64, len(self._dead))] = False
        return np.nonzero(live)[0]

    def live_vectors(self) -> tuple[np.ndarray, np.ndarray]:
        """(external ids (M,), exact f32 vectors (M, d)) of the live set, in
        slot order: what a churn-against-oracle check scans."""
        slots = self._live_slots()
        raw = corpus_raw(self.points)
        rows = raw[torch.from_numpy(slots).to(raw.device)].float().cpu().numpy()
        return self.ext_ids[slots], rows

    # -- snapshots -----------------------------------------------------------
    def snapshot(self) -> LiveSnapshot:
        return LiveSnapshot(points=self.points, graph=Graph(self.neighbors),
                            start_ids=self.start_ids, tombstones=self.tombstones,
                            ext_ids=self.ext_ids.copy(), live_count=self.live_count,
                            n_dead=self.n_dead, epoch=self.epoch, metric=self.metric,
                            labels=self.labels)

    def range(self, queries, r, *, cfg: Optional[RangeConfig] = None,
              es_radius=None, compacted: bool = True, filter=None) -> RangeResult:
        return self.snapshot().range(queries, r, cfg=cfg, es_radius=es_radius,
                                     compacted=compacted, filter=filter)

    # -- mutation: inserts ---------------------------------------------------
    def insert(self, vecs, ext_ids=None, labels=None) -> np.ndarray:
        """Insert ``vecs`` (k, d); returns their external ids (int64).

        Rows are written behind the watermark (quantized on the way in for
        an int8 corpus), then wired into the graph by ``insert_batch_step``
        in ``insert_batch`` chunks of real rows. One epoch a call.
        ``labels`` (a labeled index only) are the (k, W) packed label rows;
        omitted, the rows get zero labels.

        With a WAL attached, the call logs (resolved ext ids, vectors, label
        rows) after its validation and before any state changes, so a record
        is never logged for an insert that raises. A consolidation the
        insert needs for capacity is not logged: replaying the insert
        reproduces it."""
        if isinstance(vecs, torch.Tensor):
            vecs = vecs.detach().cpu().numpy()
        vecs = np.asarray(vecs, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        k = vecs.shape[0]
        if k == 0:
            return np.zeros((0,), np.int64)
        if self.n_live + k > self.capacity:
            raise ValueError(
                f"insert of {k} rows exceeds capacity {self.capacity} "
                f"(live_count={self.live_count}); consolidation could not "
                f"reclaim enough slots")
        if ext_ids is None:
            ext_ids = self.next_ext_id + np.arange(k, dtype=np.int64)
        else:
            ext_ids = np.asarray(ext_ids, np.int64)
            if ext_ids.shape != (k,):
                raise ValueError("ext_ids must have one id per inserted row")
            dup = [int(e) for e in ext_ids if int(e) in self._slot_of]
            if dup:
                raise ValueError(f"external ids already present: {dup[:5]}")
        if labels is not None and self.labels is None:
            raise ValueError("index has no labels attached; create(..., labels=) to "
                             "insert labeled rows")
        lab_rows = None
        if self.labels is not None:
            w = self.labels.shape[1]
            if labels is None:
                lab_rows = np.zeros((k, w), np.uint32)
            else:
                lab_rows = np.asarray(labels)
                if lab_rows.dtype == np.int32:
                    lab_rows = lab_rows.view(np.uint32)
                lab_rows = lab_rows.astype(np.uint32)
                if lab_rows.shape != (k, w):
                    raise ValueError(f"labels shape {lab_rows.shape} != ({k}, {w})")
        rec = dict(ext_ids=ext_ids, vecs=vecs)
        if lab_rows is not None:
            rec["labels"] = lab_rows
        self._log("insert", rec)
        if self.live_count + k > self.capacity and self._dead:
            # reclaim tombstoned slots first; unlogged (see above)
            self._suppress_log = True
            try:
                self.consolidate()
            finally:
                self._suppress_log = False
        dev = self.device
        B = self.cfg.insert_batch
        for off in range(0, k, B):
            chunk = vecs[off:off + B]
            b = chunk.shape[0]
            slots = np.arange(self.live_count, self.live_count + b, dtype=np.int32)
            slots_t = torch.from_numpy(slots).to(dev)
            rows_t = torch.from_numpy(chunk).to(dev)
            every = torch.ones(b, dtype=torch.bool, device=dev)
            if getattr(self.points, "is_tiered", False):
                # the hot arm takes the rows as a resident corpus does; the
                # raw rows write through to the host store (fresh slots,
                # past every published snapshot's watermark), and their
                # cache lines are dropped so no stale row can alias them
                t = self.points
                hot = corpus_set_rows(t.device, slots_t, rows_t, every)
                t.store.write(slots, chunk)
                t.cache.invalidate(slots)
                self.points = t.with_device(hot)
            else:
                self.points = corpus_set_rows(self.points, slots_t, rows_t, every)
            if lab_rows is not None:
                lab = self.labels.clone()
                lab[slots_t.long()] = as_label_rows(lab_rows[off:off + b], dev)
                self.labels = lab
            self.neighbors = insert_batch_step(
                corpus_raw(self.points), self.neighbors, slots_t, self.start_ids,
                self.build_cfg, self.build_cfg.alpha)
            self.ext_ids[slots] = ext_ids[off:off + b]
            self._slot_of.update(zip(ext_ids[off:off + b].tolist(), slots.tolist()))
            self.live_count += b
        self.next_ext_id = max(self.next_ext_id, int(ext_ids.max()) + 1)
        self.epoch += 1
        return ext_ids

    # -- mutation: deletes ---------------------------------------------------
    def delete(self, ext_ids) -> int:
        """Tombstone the given external ids (a lazy delete). Unknown and
        already deleted ids are skipped; returns how many were newly
        tombstoned. The vectors and edges stay until consolidation, so
        deleted nodes keep routing searches."""
        if isinstance(ext_ids, torch.Tensor):
            ext_ids = ext_ids.cpu().numpy()
        ext_ids = np.atleast_1d(np.asarray(ext_ids, np.int64))
        slots, seen = [], set()
        for e in ext_ids.tolist():
            s = self._slot_of.get(e)
            if s is not None and s not in self._dead and s not in seen:
                slots.append(s)
                seen.add(s)
        if slots:
            # log the REQUESTED ids before applying (idempotent on replay)
            self._log("delete", dict(ext_ids=ext_ids))
            self._dead.update(slots)
            sl = torch.tensor(slots, dtype=torch.int32, device=self.device)[None]
            # a new word tensor (snapshots keep theirs); the slots are
            # distinct and their bits clear, so the add is exact
            tomb = self.tombstones.clone()
            bitset_add(tomb[None], sl, torch.ones_like(sl, dtype=torch.bool))
            self.tombstones = tomb
            self.epoch += 1
        return len(slots)

    # -- consolidation -------------------------------------------------------
    def maybe_consolidate(self) -> bool:
        """Consolidate iff the tombstone fraction crossed the threshold."""
        if (self._dead and self.n_live > 0
                and self.tombstone_frac() >= self.cfg.consolidate_at):
            self.consolidate()
            return True
        return False

    def consolidate(self) -> dict:
        """Rewire around tombstoned nodes (delete-aware RobustPrune) and
        compact the live rows to the front of the capacity. External ids are
        stable; slots move. One epoch. An index whose every row is deleted
        is left as it is (no live row to take entry points from; the
        tombstones keep filtering every result)."""
        if not self._dead or self.n_live == 0:
            return dict(n_rewired=0, n_live=self.n_live, reclaimed=0)
        self._log("consolidate")
        dead = np.zeros(self.capacity, bool)
        dead[np.fromiter(self._dead, np.int64, len(self._dead))] = True
        tier = self.points if getattr(self.points, "is_tiered", False) else None
        pts = self.points
        if tier is not None:
            # a temporary resident corpus (the hot arm plus the host store's
            # rows on the device) for the rewiring pass; split again below
            pts = (dataclasses.replace(tier.device, raw=tier.raw_array())
                   if tier.quantized else tier.device)
        new_points, new_neighbors, new_starts, perm, stats = consolidate_index(
            pts, self.neighbors, dead, self.live_count, self.build_cfg, self.metric,
            self.cfg.n_starts, far=FAR)
        n_live = perm.shape[0]
        reclaimed = self.live_count - n_live
        if tier is not None:
            from ..tier import DeviceRowCache, HostRowStore, TieredCorpus
            raw = new_points.raw if tier.quantized else new_points
            hot = dataclasses.replace(new_points, raw=None) if tier.quantized else new_points
            # slots moved, so old cache lines would alias other rows: the
            # new tier gets an empty cache over a NEW store (the old store
            # stays valid for old snapshots)
            new_points = TieredCorpus(
                hot, HostRowStore(raw, pin=raw.device.type == "cuda"),
                DeviceRowCache(tier.cache.dim, tier.cache.capacity, raw.device),
                tier.counters, tier.fetch_bucket)
        self.points = new_points
        self.neighbors = new_neighbors
        self.start_ids = new_starts
        ext = np.full(self.capacity, INVALID_ID, np.int64)
        ext[:n_live] = self.ext_ids[perm]
        self.ext_ids = ext
        if self.labels is not None:  # labels move with their rows
            lab = torch.zeros_like(self.labels)
            lab[:n_live] = self.labels[torch.from_numpy(perm).to(self.labels.device)]
            self.labels = lab
        self.live_count = n_live
        self.tombstones = torch.zeros_like(self.tombstones)
        self._dead = set()
        self._slot_of = dict(zip(ext[:n_live].tolist(), range(n_live)))
        self.epoch += 1
        return dict(reclaimed=reclaimed, n_live=self.live_count, **stats)

    # -- checkpoint round trip -----------------------------------------------
    def save(self, manager, step: Optional[int] = None) -> str:
        """Write the whole mutable state through ``train.CheckpointManager``
        (atomic, fsynced, keep-k) in the reference's layout and dtypes:
        tombstones and labels uint32, ext ids int64, counters int64
        ``[live_count, next_ext_id, epoch, wal_seq]``. ``step`` defaults to
        the epoch. After it returns the WAL may be pruned through
        ``wal_seq`` (``wal.prune_through``)."""
        state = dict(
            neighbors=self.neighbors,
            start_ids=self.start_ids,
            tombstones=_host_words(self.tombstones),
            ext_ids=self.ext_ids,
            counters=np.asarray([self.live_count, self.next_ext_id, self.epoch,
                                 self.wal_seq], np.int64),
        )
        tier = self.points if getattr(self.points, "is_tiered", False) else None
        pts = tier.device if tier is not None else self.points
        if isinstance(pts, QuantizedCorpus):
            state["codes"] = pts.codes
            state["meta"] = pts.meta
            # tiered: the host store's own rows, the bytes queries rerank
            # against, so the store and the manifest never disagree
            state["raw"] = (np.ascontiguousarray(tier.store.to_array())
                            if tier is not None else pts.raw)
        else:
            state["points"] = pts
            if tier is not None:  # the degenerate float tier: the store rides too
                state["raw"] = np.ascontiguousarray(tier.store.to_array())
        if self.labels is not None:
            state["labels"] = _host_words(self.labels)
        extra = dict(
            kind="live_index", metric=self.metric,
            corpus_dtype=self.corpus_dtype(),
            live=dataclasses.asdict(self.cfg),
            build=dataclasses.asdict(self.build_cfg),
        )
        if tier is not None:
            extra["tier"] = dict(cache_rows=int(tier.cache.capacity),
                                 fetch_bucket=int(tier.fetch_bucket))
        return manager.save(self.epoch if step is None else step, state, extra=extra)

    @staticmethod
    def restore(manager, step: Optional[int] = None, *, wal=None,
                device="cuda") -> "LiveIndex":
        """Rebuild a ``LiveIndex`` on ``device`` from a checkpoint written by
        ``save`` (either package's). The host bookkeeping (the ext -> slot
        map, the dead-slot set) is rebuilt from the tensors. A tiered
        checkpoint's raw rows come back as a copy-on-write memory map that
        backs the host store directly.

        ``wal`` (a ``fault.WriteAheadLog``) recovers from a crash: its
        checksum-valid records past the checkpoint's ``wal_seq`` replay
        through the public mutation path (a torn tail is dropped, then
        truncated), and the log stays attached."""
        dev = resolve_device(device)
        tier_extra = manager.manifest(step)["extra"].get("tier")
        flat, manifest = manager.restore_flat(
            step, mmap=("raw",) if tier_extra is not None else None, device=dev)
        extra = manifest["extra"]
        if extra.get("kind") != "live_index":
            raise ValueError("checkpoint was not written by LiveIndex.save")
        if "points" in flat:
            points = flat["points"]
        else:
            points = QuantizedCorpus(codes=flat["codes"], meta=flat["meta"],
                                     raw=None if tier_extra is not None else flat["raw"])
        if tier_extra is not None:
            from ..tier import DeviceRowCache, HostRowStore, TieredCorpus
            raw = flat["raw"]
            points = TieredCorpus(
                points, HostRowStore(raw, copy=False),
                DeviceRowCache(raw.shape[1], tier_extra["cache_rows"], dev),
                fetch_bucket=tier_extra["fetch_bucket"])
        counters = flat["counters"].cpu().tolist()
        # checkpoints written before the WAL carry 3 counters
        live_count, next_ext_id, epoch = counters[:3]
        wal_seq = counters[3] if len(counters) > 3 else 0
        tomb = flat["tombstones"]
        dead = set()
        if live_count:
            born = torch.arange(live_count, dtype=torch.int32, device=dev)
            dead = set(torch.nonzero(bitset_contains(tomb, born)).flatten().cpu().tolist())
        idx = LiveIndex(
            points=points, neighbors=flat["neighbors"].to(torch.int32),
            start_ids=flat["start_ids"].to(torch.int32),
            ext_ids=flat["ext_ids"].cpu().numpy().astype(np.int64),
            tombstones=tomb, live_count=live_count, next_ext_id=next_ext_id,
            epoch=epoch, metric=extra["metric"], build_cfg=BuildConfig(**extra["build"]),
            cfg=LiveConfig(**extra["live"]), dead_slots=dead,
            labels=flat.get("labels"))
        idx.wal_seq = wal_seq
        if wal is not None:
            idx._replaying = True
            try:
                for rec in wal.replay(after_seq=wal_seq):
                    idx._apply_record(rec)
                    idx.wal_seq = rec.seq
            finally:
                idx._replaying = False
            idx.attach_wal(wal)
        return idx
