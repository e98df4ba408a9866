"""Fault tolerance: the error-code taxonomy of degraded responses
(:mod:`repro_torch.fault.errors`) and the live index's checksummed
write-ahead log (:mod:`repro_torch.fault.wal`). The fault injector,
shard-loss degradation and replication are a later slice of the port
(ROADMAP.md §1, item 4)."""
from .errors import DEADLINE_EXPIRED, ERROR_CODES, QUEUE_FULL, REPLICA_LOST, SHARD_LOST
from .wal import WalRecord, WriteAheadLog

__all__ = ["DEADLINE_EXPIRED", "ERROR_CODES", "QUEUE_FULL", "REPLICA_LOST",
           "SHARD_LOST", "WalRecord", "WriteAheadLog"]
