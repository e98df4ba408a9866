"""Batched fetch planning for the guard-band rerank of a tiered corpus.

The band arrives as flat (lane, slot) pairs in which the same boundary
point recurs across lanes. The plan deduplicates them to unique slots in
ascending order (row-store order), splits cache hits from misses, and cuts
the misses into buckets that the fetch path uploads while the previous
bucket scatters. Host numpy, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..utils import next_pow2


@dataclasses.dataclass
class FetchPlan:
    """The host-gather schedule for one rerank band."""

    uniques: np.ndarray       # (U,) sorted unique slots
    inverse: np.ndarray       # (P,) pair -> index into uniques
    hit_mask: np.ndarray      # (U,) True where the row is cached
    hit_lines: np.ndarray     # (U,) cache line of each hit (junk elsewhere)
    miss_chunks: List[np.ndarray]  # miss slots in buckets, each sorted

    @property
    def n_pairs(self) -> int:
        return int(self.inverse.size)

    @property
    def n_unique(self) -> int:
        return int(self.uniques.size)

    @property
    def n_miss(self) -> int:
        return sum(int(c.size) for c in self.miss_chunks)


def plan_fetch(slots: np.ndarray, cache=None,
               bucket_rows: int = 1024) -> Optional[FetchPlan]:
    """Plan the host gathers for flat rerank ``slots`` (duplicates allowed).
    ``cache`` is an optional ``DeviceRowCache`` whose hits never touch the
    host; misses go in buckets of at most ``bucket_rows`` rows (a power of
    two). None for no slots."""
    slots = np.asarray(slots).ravel()
    if slots.size == 0:
        return None
    uniques, inverse = np.unique(slots, return_inverse=True)
    if cache is not None and getattr(cache, "capacity", 0) > 0:
        hit_mask, hit_lines = cache.lookup(uniques)
    else:
        hit_mask = np.zeros(uniques.shape, bool)
        hit_lines = np.zeros(uniques.shape, np.int32)
    misses = uniques[~hit_mask]
    bucket = max(1, next_pow2(min(bucket_rows, max(1, misses.size))))
    miss_chunks = [misses[i:i + bucket] for i in range(0, misses.size, bucket)]
    return FetchPlan(uniques=uniques, inverse=inverse.astype(np.int32).ravel(),
                     hit_mask=hit_mask, hit_lines=hit_lines,
                     miss_chunks=miss_chunks)
