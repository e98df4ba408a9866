"""Fault tolerance: deadlines, shard-loss degradation, the crash-safe WAL,
replication.

- :mod:`repro_torch.fault.errors`: the error-code taxonomy of every degraded
  response (queue rejection, deadline expiry, shard loss, replica loss).
- :mod:`repro_torch.fault.wal`: the live index's append-only, checksummed
  write-ahead log, with a torn-tail-tolerant reader.
- :mod:`repro_torch.fault.injector`: a seeded, deterministic fault injector
  for (shard, replica)-level chaos tests (timeouts, errors, garbage, slow).
- :mod:`repro_torch.fault.degraded`: fault-tolerant sharded range search:
  a concurrent host fan-out over shards with per-shard validation, retries
  with jittered capped backoff, and a per-shard validity mask on the merge.
- :mod:`repro_torch.fault.replica`: R-way shard replication: bit-identical
  replica sets, hedged reads off the per-shard latency histograms,
  per-replica circuit breakers, and replica recovery.
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
from .replica import (
    BreakerConfig,
    CircuitBreaker,
    HedgePolicy,
    ReplicaFleet,
    ReplicaLost,
    ReplicatedCorpus,
    ReplicatedResult,
    replicated_fan_out,
)
from .wal import WalRecord, WriteAheadLog

__all__ = [
    "DEADLINE_EXPIRED",
    "ERROR_CODES",
    "QUEUE_FULL",
    "REPLICA_LOST",
    "SHARD_LOST",
    "BreakerConfig",
    "CircuitBreaker",
    "DegradedResult",
    "FaultInjector",
    "HedgePolicy",
    "ReplicaFleet",
    "ReplicaLost",
    "ReplicatedCorpus",
    "ReplicatedResult",
    "RetryPolicy",
    "ShardError",
    "ShardFault",
    "ShardTimeout",
    "WalRecord",
    "WriteAheadLog",
    "fault_tolerant_sharded_search",
    "merge_shard_results",
    "replicated_fan_out",
    "validate_shard_result",
]
