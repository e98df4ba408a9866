"""Fault tolerance: the error-code taxonomy of degraded responses
(:mod:`repro_torch.fault.errors`). The WAL, the fault injector, shard-loss
degradation and replication are a later slice of the port (ROADMAP.md §1)."""
from .errors import DEADLINE_EXPIRED, ERROR_CODES, QUEUE_FULL, REPLICA_LOST, SHARD_LOST

__all__ = ["DEADLINE_EXPIRED", "ERROR_CODES", "QUEUE_FULL", "REPLICA_LOST",
           "SHARD_LOST"]
