"""Bounded device-side cache of hot raw rows.

The guard band is strongly query-correlated: consecutive batches over one
corpus touch the same boundary points again, so a small device cache of
recently fetched rows absorbs much of the host traffic. The cache is a
fixed (capacity, d) f32 device buffer plus a host LRU map slot -> line;
eviction recycles the least recently used line. It is the only
device-resident raw-row storage of a tiered corpus, so its capacity is the
knob ``resident_mb`` turns; capacity 0 disables it.

Every device operation runs on the caller's current stream, so a line is
read only after the scatter that filled it.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


class DeviceRowCache:
    """LRU cache of raw f32 rows in a fixed device buffer."""

    def __init__(self, dim: int, capacity_rows: int, device="cpu"):
        self.dim = int(dim)
        self.capacity = max(0, int(capacity_rows))
        self._buf = torch.zeros((max(self.capacity, 1), self.dim),
                                dtype=torch.float32, device=device)
        self._lru: "OrderedDict[int, int]" = OrderedDict()  # slot -> line
        self._free = list(range(self.capacity - 1, -1, -1))

    @property
    def nbytes(self) -> int:
        return 0 if self.capacity == 0 else self._buf.numel() * 4

    def __len__(self) -> int:
        return len(self._lru)

    def lookup(self, slots: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(hit_mask, lines) for unique ``slots``; hits become most recent."""
        slots = np.asarray(slots, np.int64)
        hit = np.zeros(slots.shape, bool)
        lines = np.zeros(slots.shape, np.int32)
        if self.capacity:
            for i, s in enumerate(slots.tolist()):
                line = self._lru.get(s)
                if line is not None:
                    hit[i] = True
                    lines[i] = line
                    self._lru.move_to_end(s)
        return hit, lines

    def insert(self, slots: np.ndarray, rows: torch.Tensor) -> int:
        """Install freshly fetched ``rows`` (a device (m, d) tensor) for
        ``slots``; returns the number of evictions. A slot already cached is
        refreshed in place."""
        slots = np.asarray(slots, np.int64)
        if self.capacity == 0 or slots.size == 0:
            return 0
        n_evicted = 0
        lines = np.empty(slots.shape, np.int64)
        for i, s in enumerate(slots.tolist()):
            if s in self._lru:
                lines[i] = self._lru[s]
                self._lru.move_to_end(s)
            elif self._free:
                lines[i] = self._free.pop()
                self._lru[s] = int(lines[i])
            else:
                _, line = self._lru.popitem(last=False)  # the LRU line out
                n_evicted += 1
                lines[i] = line
                self._lru[s] = int(line)
        # a line taken twice in one call (capacity < m) holds the later row,
        # as the reference's scatter leaves it: keep each line's last write
        _, last = np.unique(lines[::-1], return_index=True)
        keep = np.sort(lines.size - 1 - last)
        idx = torch.from_numpy(keep).to(rows.device)
        self._buf.index_copy_(0, torch.from_numpy(lines[keep]).to(rows.device),
                              rows.index_select(0, idx).to(torch.float32))
        return n_evicted

    def invalidate(self, slots: np.ndarray) -> int:
        """Drop ``slots`` (rows rewritten in the host store: a stale line
        would break bitwise parity). Returns how many lines were dropped."""
        dropped = 0
        for s in np.asarray(slots, np.int64).tolist():
            line = self._lru.pop(s, None)
            if line is not None:
                self._free.append(int(line))
                dropped += 1
        return dropped

    def rows(self, lines) -> torch.Tensor:
        """Device gather of cached rows by line."""
        idx = torch.as_tensor(np.asarray(lines, np.int64)).to(self._buf.device)
        return self._buf.index_select(0, idx)
