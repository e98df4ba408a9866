"""Error-code taxonomy for degraded responses.

Every non-healthy ``Response`` carries exactly one of these codes so that
callers can branch on machine-readable strings instead of parsing
booleans scattered across fields:

- ``queue_full`` — the request was rejected at admission (bounded queue).
  ``op == "error"``, no results.
- ``deadline_expired`` — the request's deadline budget ran out. Either the
  request expired while still queued (``op == "error"``, no results) or its
  lane was force-finalized mid-search (``op == "range"``, certified partial
  results, ``complete=False``).
- ``shard_lost`` — one or more shards were permanently unavailable after
  retries; results cover only the surviving shards (``complete=False``,
  ``shards_ok < shards_total``).
- ``replica_lost`` — the answer is **complete** (every shard contributed:
  ``complete=True``, ``coverage == 1.0``) but one or more replicas of some
  shard are down or breaker-open, so redundancy is degraded. A health
  signal, not a correctness one; it never coexists with ``shard_lost``
  (shard loss wins when every replica of a shard is exhausted).
"""
from __future__ import annotations

QUEUE_FULL = "queue_full"
DEADLINE_EXPIRED = "deadline_expired"
SHARD_LOST = "shard_lost"
REPLICA_LOST = "replica_lost"

ERROR_CODES = frozenset({QUEUE_FULL, DEADLINE_EXPIRED, SHARD_LOST, REPLICA_LOST})
