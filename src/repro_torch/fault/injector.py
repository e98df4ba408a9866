"""Seeded, deterministic fault injection for sharded range search.

Faults are decided per ``(shard, replica, attempt)`` from a counter-based
RNG (``np.random.default_rng([seed, shard, attempt, replica])``), so two
injectors with the same seed inject the *same* faults regardless of call
order, process, or how many other shards are being searched — the property
the chaos harness relies on to replay a failure deterministically.

Four fault kinds, mirroring how real shards fail:

- ``timeout`` — the replica never answers (raised as :class:`ShardTimeout`).
- ``error``   — the replica's RPC fails outright (:class:`ShardError`).
- ``garbage`` — the replica answers with corrupted results (wrong-range ids,
  out-of-radius distances). Not raised: it exercises the *validation*
  path, which must catch it without trusting the shard.
- ``slow``    — the replica answers correctly but past the hedge deadline.
  Not raised and not a failure: it exercises the *hedging* path, which
  fires the next replica instead of waiting. Without hedging (or with no
  replica to hedge to) a slow replica is just a late success.

``down_shards`` marks shards permanently lost — every replica, every
attempt times out, so retries exhaust and the merge degrades.
``down_replicas`` marks individual ``(shard, replica)`` pairs down, the
scenario replication exists to absorb. ``script`` pins specific outcomes
for exact test scenarios; keys are ``(shard, replica, attempt)`` triples
or legacy ``(shard, attempt)`` pairs (which apply to every replica of the
shard). Scripted entries take precedence over ``down_*`` and the
probabilistic draws; triples take precedence over pairs.

This is the reference's module (numpy only) with one change: the
``injected`` tally is updated under a lock, since the fan-out's worker
threads draw their faults at once.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np

FAULT_KINDS = ("timeout", "error", "garbage", "slow")


class ShardFault(RuntimeError):
    """Base for injected shard failures; carries (kind, shard, attempt,
    replica)."""

    def __init__(self, kind: str, shard: int, attempt: int, replica: int = 0):
        super().__init__(
            f"injected {kind} on shard {shard} (attempt {attempt}, "
            f"replica {replica})")
        self.kind = kind
        self.shard = int(shard)
        self.attempt = int(attempt)
        self.replica = int(replica)


class ShardTimeout(ShardFault):
    def __init__(self, shard: int, attempt: int, replica: int = 0):
        super().__init__("timeout", shard, attempt, replica)


class ShardError(ShardFault):
    def __init__(self, shard: int, attempt: int, replica: int = 0):
        super().__init__("error", shard, attempt, replica)


@dataclasses.dataclass
class FaultInjector:
    """Deterministic per-(shard, replica, attempt) fault source."""

    seed: int = 0
    down_shards: Tuple[int, ...] = ()
    down_replicas: Tuple[Tuple[int, int], ...] = ()  # (shard, replica) pairs
    p_timeout: float = 0.0
    p_error: float = 0.0
    p_garbage: float = 0.0
    #: (shard, replica, attempt) or legacy (shard, attempt) -> kind
    script: Dict[Tuple[int, ...], Optional[str]] = dataclasses.field(default_factory=dict)
    #: mutable tally of injected faults by kind (observability, not control)
    injected: Dict[str, int] = dataclasses.field(default_factory=dict)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                              init=False, repr=False, compare=False)

    def __post_init__(self):
        for k, v in self.script.items():
            if len(k) not in (2, 3):
                raise ValueError(
                    f"script key {k!r}: expected (shard, attempt) or "
                    "(shard, replica, attempt)")
            if v is not None and v not in FAULT_KINDS:
                raise ValueError(f"script[{k}] = {v!r}; expected None or one of {FAULT_KINDS}")
        if self.p_timeout + self.p_error + self.p_garbage > 1.0:
            raise ValueError("fault probabilities must sum to <= 1")

    def rng(self, shard: int, attempt: int, replica: int = 0) -> np.random.Generator:
        """Counter-based generator for this coordinate — order-free.

        Replica 0 keys as ``[seed, shard, attempt]``, bit-for-bit the
        pre-replication stream, so single-replica chaos runs replay
        identically across versions.
        """
        key = [int(self.seed), int(shard), int(attempt)]
        if int(replica) != 0:
            key.append(int(replica))
        return np.random.default_rng(key)

    def fault_for(self, shard: int, attempt: int,
                  replica: int = 0) -> Optional[str]:
        """The fault to inject for this attempt, or None for a clean call."""
        shard, attempt, replica = int(shard), int(attempt), int(replica)
        if (shard, replica, attempt) in self.script:
            kind = self.script[(shard, replica, attempt)]
        elif (shard, attempt) in self.script:
            kind = self.script[(shard, attempt)]
        elif shard in set(self.down_shards):
            kind = "timeout"  # permanently lost: every attempt times out
        elif (shard, replica) in set(self.down_replicas):
            kind = "timeout"  # this replica is down; peers may still answer
        else:
            u = self.rng(shard, attempt, replica).random()
            if u < self.p_timeout:
                kind = "timeout"
            elif u < self.p_timeout + self.p_error:
                kind = "error"
            elif u < self.p_timeout + self.p_error + self.p_garbage:
                kind = "garbage"
            else:
                kind = None
        if kind is not None:
            with self._lock:
                self.injected[kind] = self.injected.get(kind, 0) + 1
        return kind

    def raise_if_faulted(self, shard: int, attempt: int,
                         replica: int = 0) -> Optional[str]:
        """Raise for timeout/error faults; return "garbage"/"slow" (or None)
        otherwise."""
        kind = self.fault_for(shard, attempt, replica)
        if kind == "timeout":
            raise ShardTimeout(shard, attempt, replica)
        if kind == "error":
            raise ShardError(shard, attempt, replica)
        return kind
