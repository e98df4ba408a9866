"""Sharded live index: shard-routed mutations and per-shard tombstones.

One ``LiveIndex`` a shard, each with its own pre-allocated capacity,
insert stream, tombstone bitset and consolidation schedule. The router
owns the global external-id space and the ``ext -> shard`` ownership map:

* **inserts** go to the shard with the most free capacity (least-loaded
  placement); the shard assigns slots locally and the router records the
  owner.
* **deletes** route by ownership and tombstone only the owner's bitset.
* **queries** stack the shards' tensors into a ``ShardedCorpus`` (and a
  stacked ``(S, W)`` tombstone plane) and run one
  ``dist.sharded_range_search``: every shard drops its own dead slots at
  its result stage, so the union merge sees live candidates only. The
  stacked view is cached per epoch vector, so serving pays the stack once
  a mutation batch, not once a query.

With ``replicas=R`` each shard is an R-member **replica group**: every
mutation batch fans to each member of the owning group, and since a
``LiveIndex`` mutation is a deterministic function of its state (on the
card too), members that start bit-identical stay so under churn
(``assert_replica_parity``). Queries read replica 0; ``replicated_corpus()``
gives the hedged fan-out (``fault.replica``) the stacked view of every
replica; a lost replica is rebuilt from a checkpoint and the WAL's tail
(``rebuild_replica``).

Under the port's SPMD contract (``dist``: one rank a device, every rank
making the same calls) each rank keeps every shard's ``LiveIndex`` and
applies every mutation in the same order, so their states stay equal;
``range(mesh, ...)`` stacks only the shards of the rank's model coordinate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.build import BuildConfig
from ..core.corpus import QuantizedCorpus
from ..core.range_search import RangeConfig, RangeResult
from ..dist.sharded_engine import ShardedCorpus, _held_shards, _stack, sharded_range_search
from .index import LiveConfig, LiveIndex, externalize_ids


def _own_tier(t):
    """A tiered corpus with a host store and a device row cache of its own
    (the store is written in place by inserts, so a clone must not share
    it); the hot arm is shared, since every mutation replaces it."""
    from ..tier import DeviceRowCache, HostRowStore, TieredCorpus
    return TieredCorpus(t.device, HostRowStore(t.store.to_array(), pin=t.store.pinned),
                        DeviceRowCache(t.cache.dim, t.cache.capacity, t.cache._buf.device),
                        fetch_bucket=t.fetch_bucket)


def clone_live_index(idx: LiveIndex) -> LiveIndex:
    """A bit-identical, independently mutable copy of a live index.

    Device tensors are shared where every mutation replaces them rather
    than writing into them (the corpus, the adjacency, the entry points,
    the tombstones, the label rows: ``live.index``'s snapshot rule). A
    tiered corpus's host store is written in place by inserts, so the
    clone gets its own store and row cache. Host bookkeeping is copied. The
    clone has NO WAL: in a replica group one member (the primary) logs,
    since replaying that one log reproduces every member bit for bit."""
    points = _own_tier(idx.points) if getattr(idx.points, "is_tiered", False) else idx.points
    clone = LiveIndex(
        points=points, neighbors=idx.neighbors, start_ids=idx.start_ids,
        ext_ids=idx.ext_ids.copy(), tombstones=idx.tombstones,
        live_count=idx.live_count, next_ext_id=idx.next_ext_id,
        epoch=idx.epoch, metric=idx.metric, build_cfg=idx.build_cfg,
        cfg=idx.cfg, dead_slots=set(idx._dead), labels=idx.labels)
    clone.wal_seq = idx.wal_seq  # the same mutation history, no log handle
    return clone


def _point_leaves(points) -> list:
    if getattr(points, "is_tiered", False):
        return _point_leaves(points.device) + [torch.from_numpy(points.store.to_array())]
    if isinstance(points, QuantizedCorpus):
        return [points.codes, points.meta] + ([] if points.raw is None else [points.raw])
    return [points]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


class LiveShardedIndex:
    """Router over per-shard ``LiveIndex`` sub-indices (a common capacity),
    optionally R-way replicated (``replica_groups``)."""

    def __init__(self, shards: list[LiveIndex],
                 replica_groups: Optional[list[list[LiveIndex]]] = None):
        if not shards:
            raise ValueError("need at least one shard")
        if replica_groups is None:
            replica_groups = [[sh] for sh in shards]
        if len(replica_groups) != len(shards) or any(
                g[0] is not sh for g, sh in zip(replica_groups, shards)):
            raise ValueError("replica_groups[s][0] must be shards[s]")
        n_rep = len(replica_groups[0])
        if any(len(g) != n_rep for g in replica_groups):
            raise ValueError("every shard needs the same replica count")
        cap = shards[0].capacity
        deg = shards[0].neighbors.shape[1]
        for g in replica_groups:
            for sh in g:
                if sh.capacity != cap or sh.neighbors.shape[1] != deg:
                    raise ValueError("shards must share capacity and max degree")
                if sh.metric != shards[0].metric:
                    raise ValueError("shards must share the metric")
        self.shards = shards
        self.groups = replica_groups
        self.next_ext_id = max(sh.next_ext_id for sh in shards)
        self._owner: dict[int, int] = {}
        for si, sh in enumerate(shards):
            for e in sh._slot_of:
                self._owner[e] = si
        self._view_cache: Optional[tuple] = None

    # -- construction --------------------------------------------------------
    @staticmethod
    def create(points, n_shards: int, cfg: LiveConfig,
               build_cfg: Optional[BuildConfig] = None, metric: str = "l2",
               corpus_dtype: str = "float32", seed: int = 0,
               replicas: int = 1, *, device="cuda") -> "LiveShardedIndex":
        """Partition ``points`` into contiguous blocks, one live sub-index
        (a Vamana build on ``device``) a block; ``cfg.capacity`` is the
        PER-SHARD capacity. With ``replicas=R`` each shard is built once and
        cloned R-1 times (bit-identical by construction)."""
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        pts = (points.detach().cpu().numpy() if isinstance(points, torch.Tensor)
               else np.asarray(points, np.float32))
        n = -(-pts.shape[0] // n_shards)
        shards = [LiveIndex.create(pts[s * n:(s + 1) * n], cfg, build_cfg=build_cfg,
                                   metric=metric, corpus_dtype=corpus_dtype, seed=seed + s,
                                   first_ext_id=s * n, device=device)
                  for s in range(n_shards)]
        groups = [[sh] + [clone_live_index(sh) for _ in range(replicas - 1)]
                  for sh in shards]
        idx = LiveShardedIndex(shards, replica_groups=groups)
        idx.next_ext_id = pts.shape[0]
        return idx

    # -- introspection -------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_replicas(self) -> int:
        return len(self.groups[0])

    @property
    def n_live(self) -> int:
        return sum(sh.n_live for sh in self.shards)

    def epochs(self) -> tuple:
        return tuple(sh.epoch for sh in self.shards)

    def stats(self) -> dict:
        return dict(n_shards=self.n_shards, n_live=self.n_live,
                    epochs=list(self.epochs()),
                    shards=[sh.stats() for sh in self.shards])

    def live_vectors(self) -> tuple[np.ndarray, np.ndarray]:
        pairs = [sh.live_vectors() for sh in self.shards]
        return (np.concatenate([p[0] for p in pairs]),
                np.concatenate([p[1] for p in pairs]))

    # -- mutation ------------------------------------------------------------
    def insert(self, vecs) -> np.ndarray:
        """Route to the least-loaded shard; a batch larger than its free
        space splits greedily across shards by free capacity (tombstoned
        slots count as free: a shard's insert reclaims them by consolidating
        when it must). Every member of the owning group takes the rows."""
        if isinstance(vecs, torch.Tensor):
            vecs = vecs.detach().cpu().numpy()
        vecs = np.asarray(vecs, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        k = vecs.shape[0]
        if k == 0:
            return np.zeros((0,), np.int64)
        free = [sh.capacity - sh.n_live for sh in self.shards]
        if sum(free) < k:
            raise ValueError(f"insert of {k} rows exceeds the fleet's free "
                             f"capacity {sum(free)}")
        ext = self.next_ext_id + np.arange(k, dtype=np.int64)
        off = 0
        while off < k:
            si = int(np.argmax(free))
            take = min(k - off, free[si])
            for member in self.groups[si]:
                member.insert(vecs[off:off + take], ext_ids=ext[off:off + take])
            for e in ext[off:off + take]:
                self._owner[int(e)] = si
            free[si] -= take
            off += take
        self.next_ext_id += k
        return ext

    def delete(self, ext_ids) -> int:
        """Tombstone each id in its owning shard's bitset (every member)."""
        if isinstance(ext_ids, torch.Tensor):
            ext_ids = ext_ids.cpu().numpy()
        ext_ids = np.atleast_1d(np.asarray(ext_ids, np.int64))
        per_shard: dict[int, list[int]] = {}
        for e in ext_ids:
            si = self._owner.get(int(e))
            if si is not None:
                per_shard.setdefault(si, []).append(int(e))
        deleted = 0
        for si, ids in per_shard.items():
            for member in self.groups[si]:
                n = member.delete(np.asarray(ids, np.int64))
            deleted += n  # the members agree by parity: count once
        return deleted

    def maybe_consolidate(self) -> int:
        """Per-shard threshold check; returns the shards consolidated. A
        group consolidates together (the decision is a function of state its
        members share bit for bit)."""
        done = 0
        for g in self.groups:
            ran = [bool(member.maybe_consolidate()) for member in g]
            if any(ran) != all(ran):  # diverged state: parity was broken
                raise AssertionError("replica group disagreed on consolidation")
            done += int(ran[0])
        return done

    # -- replication ---------------------------------------------------------
    def assert_replica_parity(self) -> None:
        """Every member of every group equals its primary bit for bit
        (compared on the device), the invariant that makes replica choice
        unobservable. Raises ``AssertionError`` naming the diverging field."""
        for si, g in enumerate(self.groups):
            base = g[0]
            for ri, member in enumerate(g[1:], start=1):
                for field in ("neighbors", "start_ids", "tombstones"):
                    if not _same(getattr(base, field), getattr(member, field)):
                        raise AssertionError(f"shard {si} replica {ri}: {field} diverged")
                a, b = _point_leaves(base.points), _point_leaves(member.points)
                if len(a) != len(b) or not all(_same(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"shard {si} replica {ri}: points diverged")
                if not np.array_equal(base.ext_ids, member.ext_ids):
                    raise AssertionError(f"shard {si} replica {ri}: ext_ids diverged")
                if (base.live_count, base.epoch, base.next_ext_id) != (
                        member.live_count, member.epoch, member.next_ext_id):
                    raise AssertionError(f"shard {si} replica {ri}: counters diverged")
                if base.labels is not None and (member.labels is None or not _same(
                        base.labels, member.labels)):
                    raise AssertionError(f"shard {si} replica {ri}: labels diverged")

    def rebuild_replica(self, shard: int, replica: int, manager, *,
                        step: Optional[int] = None, wal=None) -> LiveIndex:
        """Rebuild a lost replica from a checkpoint and the WAL's tail, on
        its group's device, and re-admit it.

        ``manager`` is the ``train.CheckpointManager`` holding the shard's
        last ``LiveIndex.save``; ``wal`` (optional) replays the mutations
        past the checkpoint's ``wal_seq``. Replay is deterministic, so the
        rebuilt member equals its peers bit for bit (check with
        ``assert_replica_parity``). It does not log: the primary keeps the
        group's WAL."""
        if replica == 0:
            raise ValueError("replica 0 is the primary; restore the shard "
                             "via LiveIndex.restore instead")
        idx = LiveIndex.restore(manager, step, wal=wal, device=self.shards[shard].device)
        idx.wal = None  # exactly one member of the group logs
        self.groups[shard][replica] = idx
        return idx

    def replicated_corpus(self):
        """Each replica column stacked into a ``ShardedCorpus`` (every
        shard), the R columns wrapped as a ``fault.ReplicatedCorpus``, with
        the stacked tombstones and flat external ids of ``_stacked_view``,
        for the hedged host fan-out. The columns are bit-equal by parity."""
        from ..fault.replica import ReplicatedCorpus
        corpus0, tomb, flat_ext = self._stacked_view()
        columns = [corpus0] + [self._stack([g[ri] for g in self.groups], range(self.n_shards))
                               for ri in range(1, self.n_replicas)]
        return ReplicatedCorpus(replicas=columns), tomb, flat_ext

    # -- queries -------------------------------------------------------------
    def _stack(self, members: list[LiveIndex], held: range) -> ShardedCorpus:
        """The ``held`` shards of ``members`` (one a shard) as a
        ``ShardedCorpus`` over all S shards' slot space."""
        if any(getattr(members[s].points, "is_tiered", False) for s in held):
            raise ValueError("a tiered live shard cannot be stacked into a ShardedCorpus")
        cap = self.shards[0].capacity
        dev = self.shards[0].device
        return ShardedCorpus(
            points=_stack([members[s].points for s in held]),
            neighbors=torch.stack([members[s].neighbors for s in held]),
            start_ids=torch.stack([members[s].start_ids for s in held]),
            offsets=torch.tensor([s * cap for s in held], dtype=torch.int32, device=dev),
            n_total=self.n_shards * cap, first_shard=held.start,
            total_shards=self.n_shards)

    def _stacked_view(self, mesh=None, model_axis: str = "model"):
        """(ShardedCorpus of the held shards (every shard without a mesh),
        tombstones (S, W), flat external ids (S * cap,)), cached per epoch
        vector and held range (rebuilt only after a mutation batch)."""
        held = _held_shards(mesh, self.n_shards, model_axis)
        key = (self.epochs(), held)
        if self._view_cache is not None and self._view_cache[0] == key:
            return self._view_cache[1]
        view = (self._stack(self.shards, held),
                torch.stack([sh.tombstones for sh in self.shards]),
                np.concatenate([sh.ext_ids for sh in self.shards]))
        self._view_cache = (key, view)
        return view

    def range(self, mesh, queries, r, cfg: RangeConfig, es_radius=None) -> RangeResult:
        """Union range search over every shard; the returned ids are
        EXTERNAL (an int64 tensor on the result's device). Every rank of
        ``mesh`` makes the same call and gets the same result."""
        corpus, tomb, flat_ext = self._stacked_view(mesh)
        res = sharded_range_search(mesh=mesh, corpus=corpus, queries=queries, r=r, cfg=cfg,
                                   es_radius=es_radius, tombstones=tomb)
        ext = torch.from_numpy(externalize_ids(flat_ext, res.ids))
        return dataclasses.replace(res, ids=ext.to(res.ids.device))
