"""``TieredCorpus``: device-resident codes, host-resident rerank rows.

The hot arm (``device``) is what the search loop reads: an int8
``QuantizedCorpus`` whose ``raw`` is None (codes and 12-byte metadata
only), or, for the degenerate f32/bf16 tier, the cast tensor itself. The
cold arm is a ``HostRowStore`` of exact f32 rows that only the guard-band
rerank and the filtered fallback scan read, through
:meth:`TieredCorpus.exact_pairs`.

Bitwise parity: ``exact_pairs`` returns the same f32 bits as the resident
path for every pair. It assembles the band's distinct rows into a (U, d)
device buffer and makes one ``fetch_rerank_pairs`` call over that buffer
and the pairs' inverse ids, with the resident call's lanes: the same kernel
on the same number of pairs, the same route and the same per-pair sum, so
the cache's size and history and the fetch buckets cannot move a bit.

On a CUDA corpus the miss buckets stream through two pinned staging
buffers: the host gathers bucket i+1 while bucket i's upload runs on a side
stream, and the current stream scatters bucket i once an event says its
upload landed. A staging buffer is refilled only after the event of its
previous upload.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from ..core.corpus import QuantizedCorpus, corpus_cast, quantize_corpus
from ..core.range_search import exact_pair_dists
from ..utils import resolve_device
from .budget import MemoryBudget
from .cache import DeviceRowCache
from .planner import plan_fetch
from .store import HostRowStore

# the memory-cap hook: forces a small row cache on every tier built with
# the default size
_CACHE_ROWS_ENV = "REPRO_TIER_CACHE_ROWS"


@dataclasses.dataclass
class TierCounters:
    """Cumulative fetch-path counters of one tier (shared by its
    ``with_device`` views)."""

    pairs: int = 0            # (lane, slot) pairs planned
    unique_rows: int = 0      # after dedup
    fetched_rows: int = 0     # rows copied host -> device
    fetched_bytes: int = 0
    fetch_batches: int = 0    # buckets uploaded
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0

    @property
    def dedup_ratio(self) -> float:
        return self.pairs / max(1, self.unique_rows)

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / max(1, self.cache_hits + self.cache_misses)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dedup_ratio"] = round(self.dedup_ratio, 4)
        d["cache_hit_rate"] = round(self.hit_rate, 4)
        return d


class _Uploads:
    """Two pinned staging buffers of ``rows`` x ``dim`` f32 and their
    device twins, with the events that order their reuse."""

    def __init__(self, rows: int, dim: int, device: torch.device):
        self.host = [torch.empty((rows, dim), pin_memory=True) for _ in range(2)]
        self.dev = [torch.empty((rows, dim), device=device) for _ in range(2)]
        self.copied = [torch.cuda.Event() for _ in range(2)]
        self.used = [torch.cuda.Event() for _ in range(2)]
        self.side = torch.cuda.Stream(device)


class TieredCorpus:
    """Two-tier corpus: device hot arm + host-memory raw-row store."""

    is_tiered = True  # the marker core duck-types on (core never imports tier)

    def __init__(self, device: Any, store: HostRowStore, cache: DeviceRowCache,
                 counters: Optional[TierCounters] = None, fetch_bucket: int = 1024):
        self.device = device
        self.store = store
        self.cache = cache
        self.counters = counters if counters is not None else TierCounters()
        self.fetch_bucket = int(fetch_bucket)
        self._uploads = None

    def with_device(self, device: Any) -> "TieredCorpus":
        """A view with another hot arm that shares the store, the cache and
        the counters."""
        return TieredCorpus(device, self.store, self.cache, self.counters,
                            self.fetch_bucket)

    @property
    def n(self) -> int:
        return len(self.store)

    @property
    def dim(self) -> int:
        return self.store.dim

    def raw_array(self) -> torch.Tensor:
        """The whole host store uploaded to the hot arm's device (graph
        mutation and consolidation; never on the query path)."""
        return torch.from_numpy(self.store.to_array()).to(self.device.device)

    @property
    def quantized(self) -> bool:
        return isinstance(self.device, QuantizedCorpus)

    def budget(self) -> MemoryBudget:
        device: dict = {}
        if self.quantized:
            device["codes"] = self.device.codes.numel()
            device["meta"] = self.device.meta.numel() * 4
        else:
            device["points"] = self.device.numel() * self.device.element_size()
        device["row_cache"] = self.cache.nbytes
        return MemoryBudget(device=device, host={"row_store": self.store.nbytes})

    # -- the rerank fetch path ----------------------------------------------
    def exact_pairs(self, queries, ids_p, lanes_p, metric: str,
                    use_kernel: bool = True) -> torch.Tensor:
        """(P,) exact f32 distances of flat (corpus id, lane) pairs, the
        rows fetched from the cache or the host store."""
        if not self.quantized:  # the degenerate tier: the hot arm is exact
            return exact_pair_dists(self.device, queries, ids_p, lanes_p, metric,
                                    use_kernel)
        dev = self.device.device
        ids_np = ids_p.cpu().numpy().astype(np.int64)
        plan = plan_fetch(ids_np, self.cache, self.fetch_bucket)
        if plan is None:
            return torch.empty((0,), dtype=torch.float32, device=dev)
        c = self.counters
        c.pairs += plan.n_pairs
        c.unique_rows += plan.n_unique
        c.cache_hits += int(plan.hit_mask.sum())
        c.cache_misses += plan.n_miss

        rows_u = torch.empty((plan.n_unique, self.dim), dtype=torch.float32, device=dev)
        hit_pos = np.nonzero(plan.hit_mask)[0]
        if hit_pos.size:
            rows_u[torch.from_numpy(hit_pos).to(dev)] = self.cache.rows(
                plan.hit_lines[plan.hit_mask])
        miss_pos = np.nonzero(~plan.hit_mask)[0]
        done = 0
        for chunk, rows in self._stream(plan.miss_chunks, dev):
            pos = torch.from_numpy(miss_pos[done:done + chunk.size]).to(dev)
            rows_u.index_copy_(0, pos, rows)
            done += chunk.size
            c.fetch_batches += 1
            c.fetched_rows += int(chunk.size)
            c.fetched_bytes += int(chunk.size) * self.dim * 4
            c.cache_evictions += self.cache.insert(chunk, rows)
        inv = torch.from_numpy(plan.inverse).to(dev)
        return exact_pair_dists(rows_u, queries, inv, lanes_p, metric, use_kernel)

    def _stream(self, chunks, dev: torch.device):
        """Yield (chunk, its rows on the device) for each miss bucket. On a
        CUDA corpus bucket i+1 is gathered and uploaded on a side stream
        while the caller scatters bucket i on the current stream."""
        if dev.type != "cuda":
            for chunk in chunks:
                yield chunk, self.store.gather(chunk).to(dev)
            return
        if self._uploads is None:
            self._uploads = _Uploads(self.fetch_bucket, self.dim, dev)
        up = self._uploads
        cur = torch.cuda.current_stream(dev)

        def upload(i: int) -> torch.Tensor:
            k, m = i % 2, chunks[i].size
            up.copied[k].synchronize()        # its last upload left the buffer
            self.store.gather(chunks[i], out=up.host[k])
            up.side.wait_event(up.used[k])    # its last rows were consumed
            with torch.cuda.stream(up.side):
                up.dev[k][:m].copy_(up.host[k][:m], non_blocking=True)
                up.copied[k].record(up.side)
            return up.dev[k][:m]

        nxt = upload(0) if chunks else None
        for i, chunk in enumerate(chunks):
            rows = nxt
            if i + 1 < len(chunks):
                nxt = upload(i + 1)
            cur.wait_event(up.copied[i % 2])
            yield chunk, rows
            up.used[i % 2].record(cur)


def tiered_corpus(points, *, corpus_dtype: str = "int8",
                  cache_rows: Optional[int] = None,
                  resident_mb: Optional[float] = None,
                  fetch_bucket: int = 1024, device="cuda") -> TieredCorpus:
    """Split ``points`` ((N, d) numpy or tensor, or a ``QuantizedCorpus``
    whose raw rows move to the host) into a ``TieredCorpus`` on ``device``.
    A float ``corpus_dtype`` makes the degenerate tier (the hot arm is the
    cast tensor; queries never fetch). ``resident_mb`` caps the device row
    cache in MB (it wins over ``cache_rows``); with neither, the cache holds
    n/8 rows, or ``REPRO_TIER_CACHE_ROWS`` rows where that is set."""
    dev = resolve_device(device)
    if isinstance(points, QuantizedCorpus):
        if points.raw is None:
            raise ValueError("tiered_corpus needs raw rows to fill the host "
                             "store (got a QuantizedCorpus with raw=None)")
        raw = points.raw
        hot = QuantizedCorpus(codes=points.codes.to(dev), meta=points.meta.to(dev),
                              raw=None)
    else:
        raw = torch.as_tensor(points).to(device=dev, dtype=torch.float32).contiguous()
        hot = (quantize_corpus(raw, keep_raw=False) if corpus_dtype == "int8"
               else corpus_cast(raw, corpus_dtype))
    n, d = raw.shape
    store = HostRowStore(raw, pin=dev.type == "cuda")
    del raw
    if resident_mb is not None:
        cap = int(resident_mb * (1 << 20)) // max(1, d * 4)
    elif cache_rows is not None:
        cap = int(cache_rows)
    else:
        cap = int(os.environ.get(_CACHE_ROWS_ENV, max(1, n // 8)))
    return TieredCorpus(hot, store, DeviceRowCache(d, cap, dev),
                        fetch_bucket=fetch_bucket)
