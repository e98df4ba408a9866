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

The live index writes through: ``write`` fills fresh slots in place,
``take`` compacts into a new store (the old one stays valid for the
snapshots that hold it), ``to_array`` is the checkpoint payload.
"""
from __future__ import annotations

import numpy as np
import torch

ROW_ALIGN = 64  # bytes: the row stride's granularity


class TierFetchError(RuntimeError):
    """A host-store row fetch failed (a bad slot or a scripted fault)."""


class HostRowStore:
    """Row-aligned host store of exact f32 rerank rows; ``pin`` page-locks
    it (a CUDA corpus's store).

    ``copy=False`` wraps an (N, d) f32 numpy array as it is, without the
    aligned copy: a copy-on-write memory map of a checkpoint leaf, which
    writes then go through. Such a store is not pinned (page-locking would
    fault the whole map in), so its uploads are staged through the pinned
    buffers of ``TieredCorpus``."""

    def __init__(self, rows, *, pin: bool = False, copy: bool = True,
                 align: int = ROW_ALIGN):
        if not copy:
            if not isinstance(rows, np.ndarray) or rows.dtype != np.float32 or rows.ndim != 2:
                raise ValueError("copy=False wraps an (N, d) float32 numpy array")
            self._buf = self._rows = torch.from_numpy(rows)
            self.n, self.dim = (int(s) for s in rows.shape)
            self.pinned = False
            self.fail_next = 0
            return
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

    def write(self, slots, vecs) -> None:
        """Write rows in place. Sound for the live index's inserts only:
        their slots lie past every published snapshot's watermark."""
        idx = torch.as_tensor(np.asarray(slots, np.int64))
        self._rows[idx] = torch.as_tensor(np.asarray(vecs, np.float32))

    def take(self, idx) -> "HostRowStore":
        """A new store of rows ``idx`` in order (consolidation's compaction;
        the old store stays valid for old snapshots)."""
        rows = self._rows.index_select(0, torch.as_tensor(np.asarray(idx, np.int64)))
        return HostRowStore(rows, pin=self.pinned)

    def to_array(self) -> np.ndarray:
        """The (N, d) rows as a numpy view, no copy: the checkpoint payload."""
        return self._rows.numpy()
