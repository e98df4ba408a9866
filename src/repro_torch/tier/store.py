"""Host-memory raw-row store: the cold tier of a ``TieredCorpus``.

The guard-band rerank is the only reader of exact f32 rows; the search loop
runs on int8 codes and 12-byte metadata. So the codes, metadata and graph
stay on the device and the raw rows live here, fetched for the ambiguous
band only (the DiskANN memory split).

Rows are laid out DiskANN-style: each takes a fixed stride rounded up to
``ROW_ALIGN`` bytes of one contiguous buffer. For a CUDA corpus the buffer
is pinned (page-locked), so an upload from it is a DMA the host does not
copy through; ``gather(..., out=)`` writes into a pinned staging buffer for
the same reason.

A failed fetch raises :class:`TierFetchError`; ``fail_next`` scripts such
failures for tests.
"""
from __future__ import annotations

import numpy as np
import torch

ROW_ALIGN = 64  # bytes: the row stride's granularity


class TierFetchError(RuntimeError):
    """A host-store row fetch failed (a bad slot or a scripted fault)."""


class HostRowStore:
    """Row-aligned host store of exact f32 rerank rows; ``pin`` page-locks
    it (a CUDA corpus's store)."""

    def __init__(self, rows, *, pin: bool = False, align: int = ROW_ALIGN):
        rows = torch.as_tensor(np.asarray(rows, dtype=np.float32)
                               if not isinstance(rows, torch.Tensor) else rows)
        rows = rows.detach().to("cpu", torch.float32)
        if rows.dim() != 2:
            raise ValueError(f"store rows must be (N, d), got {tuple(rows.shape)}")
        n, d = rows.shape
        self.n, self.dim = int(n), int(d)
        stride = max(1, -(-d * 4 // align) * align // 4)
        self._buf = torch.zeros((n, stride), dtype=torch.float32, pin_memory=pin)
        self._buf[:, :d] = rows
        self._rows = self._buf[:, :d]
        self.pinned = pin
        self.fail_next = 0  # the next N gathers raise TierFetchError

    @property
    def nbytes(self) -> int:
        """Host bytes kept resident (alignment padding included)."""
        return self._buf.numel() * 4

    @property
    def stride(self) -> int:
        """Floats a row occupies in the buffer."""
        return self._buf.shape[1]

    def __len__(self) -> int:
        return self.n

    def gather(self, slots, out=None) -> torch.Tensor:
        """Rows by slot, (m, d) f32 with the stored bits, into ``out[:m]``
        (a staging buffer) when given."""
        if self.fail_next > 0:
            self.fail_next -= 1
            raise TierFetchError(f"scripted host-store fetch failure "
                                 f"({np.size(slots)} rows)")
        idx = torch.as_tensor(np.asarray(slots, np.int64))
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= self.n):
            raise TierFetchError(f"host-store fetch out of range: slots in "
                                 f"[{int(idx.min())}, {int(idx.max())}] vs {self.n} rows")
        if out is None:
            return self._rows.index_select(0, idx)
        dst = out[:idx.numel()]
        torch.index_select(self._rows, 0, idx, out=dst)
        return dst
