"""Append-only write-ahead log for live-index mutation batches.

Pure numpy and the standard library, with the reference's byte format
exactly, so a log written by either package replays in the other.

Record layout (little-endian), one record per mutation batch::

    [crc32: u32] [payload_len: u32] [seq: u64] [op: u8] [payload: bytes]

``crc32`` covers everything after itself (the 13 header bytes
``payload_len | seq | op`` plus the payload), so a torn or bit-flipped
record fails its checksum as a unit. ``seq`` is the index's monotonically
increasing mutation sequence number (independent of the structural
``epoch``, which can advance more than once inside a single public
mutation). The payload is an ``np.savez`` archive of named arrays; what
the arrays mean depends on ``op``:

- ``insert``  — ``ext_ids (B,) int64``, ``vecs (B, d)`` (corpus dtype),
  plus ``labels (B, W) uint32`` packed label rows when the index is
  labeled (absent otherwise — replay passes None through).
  The logged ``ext_ids`` are the *resolved* ids (auto-assigned ids are
  materialized before logging), so replay never re-derives them.
- ``delete``  — ``ext_ids (B,) int64`` as requested (idempotent on replay).
- ``consolidate`` — empty payload; records an explicit external
  consolidation. Consolidations triggered *inside* ``insert`` are not
  logged: replaying the insert record reproduces them deterministically.

Replay rules (torn-tail tolerance):

1. Records are read in file order; each is accepted only if its header
   parses, the payload is fully present, and the checksum matches.
2. The first record that fails any of these checks ends the replayable
   prefix — it and everything after it are discarded as a torn tail
   (a crash mid-``append``). Nothing before it is affected.
3. ``live.LiveIndex.restore`` applies the records with ``seq`` strictly greater
   than the checkpoint's ``wal_seq``, in order. Because every mutation is
   deterministic, replaying the surviving prefix reproduces the
   uninterrupted state bit-for-bit up to the last durable record.

Appends ``flush`` + ``fsync`` by default so a record returned from
``append`` is durable; pass ``fsync=False`` for throughput when the
durability point is managed elsewhere (e.g. group commit).
"""
from __future__ import annotations

import dataclasses
import io
import os
import struct
import zlib
from typing import Dict, Iterable, List, Optional

import numpy as np

_HEADER = struct.Struct("<IIQB")  # crc32, payload_len, seq, op
_OPS = {1: "insert", 2: "delete", 3: "consolidate"}
_OP_CODES = {v: k for k, v in _OPS.items()}

#: Ceiling on a single record's payload; a parsed length above this is
#: treated as corruption (ends the replayable prefix) rather than an
#: attempt to allocate garbage.
MAX_PAYLOAD_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One durable mutation batch: ``(seq, op, named arrays)``."""

    seq: int
    op: str
    arrays: Dict[str, np.ndarray]


def _encode_payload(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def _decode_payload(raw: bytes) -> Dict[str, np.ndarray]:
    if not raw:
        return {}
    with np.load(io.BytesIO(raw)) as z:
        return {k: z[k] for k in z.files}


def encode_record(seq: int, op: str, arrays: Dict[str, np.ndarray]) -> bytes:
    """Serialize one record; the inverse of the reader's per-record parse."""
    if op not in _OP_CODES:
        raise ValueError(f"unknown WAL op {op!r}; expected one of {sorted(_OP_CODES)}")
    payload = _encode_payload(arrays)
    body = _HEADER.pack(0, len(payload), int(seq), _OP_CODES[op])[4:] + payload
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return struct.pack("<I", crc) + body


class WriteAheadLog:
    """Append-only mutation log with checksummed records.

    The write handle stays open in append mode across calls; ``replay``
    opens its own read handle so a live writer and a recovery reader can
    coexist on the same path.
    """

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = str(path)
        self._fsync = bool(fsync)
        self._fh = open(self.path, "ab")

    # -- writing ----------------------------------------------------------
    def append(self, seq: int, op: str, arrays: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Append one record; returns the bytes written.

        Durable on return when ``fsync=True`` (the default): the record is
        flushed and fsynced before control returns to the caller, which is
        what makes logging *before* applying a true write-ahead protocol.
        """
        rec = encode_record(seq, op, arrays or {})
        self._fh.write(rec)
        self._fh.flush()
        if self._fsync:
            os.fsync(self._fh.fileno())
        return len(rec)

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reading ----------------------------------------------------------
    def scan(self) -> tuple[List[WalRecord], int, bool]:
        """Parse the log; returns ``(records, durable_bytes, torn)``.

        ``records`` is the longest checksum-valid prefix, ``durable_bytes``
        the file offset just past it, and ``torn`` whether trailing bytes
        beyond the prefix were discarded.
        """
        self._fh.flush()
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return [], 0, False
        records: List[WalRecord] = []
        off = 0
        while off + _HEADER.size <= len(raw):
            crc, length, seq, opc = _HEADER.unpack_from(raw, off)
            end = off + _HEADER.size + length
            if length > MAX_PAYLOAD_BYTES or opc not in _OPS or end > len(raw):
                break
            if zlib.crc32(raw[off + 4 : end]) & 0xFFFFFFFF != crc:
                break
            try:
                arrays = _decode_payload(raw[off + _HEADER.size : end])
            except Exception:
                break
            records.append(WalRecord(seq=int(seq), op=_OPS[opc], arrays=arrays))
            off = end
        return records, off, off < len(raw)

    def replay(self, after_seq: int = -1) -> Iterable[WalRecord]:
        """Yield the checksum-valid records with ``seq > after_seq``."""
        records, _, _ = self.scan()
        return [r for r in records if r.seq > after_seq]

    @property
    def last_seq(self) -> int:
        """Sequence number of the last durable record (-1 if empty)."""
        records, _, _ = self.scan()
        return records[-1].seq if records else -1

    # -- maintenance ------------------------------------------------------
    def truncate_torn_tail(self) -> bool:
        """Drop any torn tail in place; returns whether bytes were removed.

        Call before resuming appends on a log recovered from a crash, so
        new records land after the durable prefix instead of after garbage
        (which would otherwise shadow them from every future replay).
        """
        _, durable, torn = self.scan()
        if torn:
            self._fh.close()
            with open(self.path, "rb+") as f:
                f.truncate(durable)
                f.flush()
                os.fsync(f.fileno())
            self._fh = open(self.path, "ab")
        return torn

    def prune_through(self, seq: int) -> int:
        """Atomically rewrite the log keeping only records with ``seq >``.

        Run after a durable checkpoint at ``wal_seq == seq`` to bound log
        growth; returns the number of records dropped. The rewrite goes
        through a temp file + ``os.replace`` so a crash mid-prune leaves
        either the old or the new log, never a hybrid.
        """
        records, _, _ = self.scan()
        keep = [r for r in records if r.seq > seq]
        dropped = len(records) - len(keep)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for r in keep:
                f.write(encode_record(r.seq, r.op, r.arrays))
            f.flush()
            os.fsync(f.fileno())
        self._fh.close()
        os.replace(tmp, self.path)
        dirfd = os.open(os.path.dirname(os.path.abspath(self.path)), os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        self._fh = open(self.path, "ab")
        return dropped
