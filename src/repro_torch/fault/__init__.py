"""Fault tolerance: deadlines, shard-loss degradation, the crash-safe WAL.

- :mod:`repro_torch.fault.errors`: the error-code taxonomy of every degraded
  response (queue rejection, deadline expiry, shard loss, replica loss).
- :mod:`repro_torch.fault.wal`: the live index's append-only, checksummed
  write-ahead log, with a torn-tail-tolerant reader.
- :mod:`repro_torch.fault.injector`: a seeded, deterministic fault injector
  for shard-level chaos tests (timeouts, errors, garbage, slow).
- :mod:`repro_torch.fault.degraded`: fault-tolerant sharded range search:
  a concurrent host fan-out over shards with per-shard validation, retries
  with jittered capped backoff, and a per-shard validity mask on the merge.

Replication (``fault/replica.py``) is ROADMAP.md §1, item 4.
"""
from .degraded import (
    DegradedResult,
    RetryPolicy,
    fault_tolerant_sharded_search,
    merge_shard_results,
    validate_shard_result,
)
from .errors import DEADLINE_EXPIRED, ERROR_CODES, QUEUE_FULL, REPLICA_LOST, SHARD_LOST
from .injector import FaultInjector, ShardError, ShardFault, ShardTimeout
from .wal import WalRecord, WriteAheadLog

__all__ = ["DEADLINE_EXPIRED", "ERROR_CODES", "QUEUE_FULL", "REPLICA_LOST", "SHARD_LOST",
           "DegradedResult", "FaultInjector", "RetryPolicy", "ShardError", "ShardFault",
           "ShardTimeout", "WalRecord", "WriteAheadLog", "fault_tolerant_sharded_search",
           "merge_shard_results", "validate_shard_result"]
