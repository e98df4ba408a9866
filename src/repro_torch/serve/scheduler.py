"""LaneScheduler: a persistent pool of resumable greedy lanes.

The lockstep path (``range_search_compacted``) answers a micro-batch by
running every saturated lane's greedy phase to completion in one call: the
whole batch waits for its slowest member. Continuous batching breaks the
lockstep: phase-2 work lives in a fixed-width pool of ``GreedyState``
checkpoints, advanced ``slice_rounds`` expansions a tick. Finished lanes
retire and free their slot; newly admitted lanes fill free slots between
ticks, so a straggler keeps its one slot while traffic flows around it.

The pool width ``L`` is rounded up to a power of two (the slot count callers
see). The reference pads its admission scatters and retirement gathers to
power-of-two index vectors to bound its jit variants; eager PyTorch needs
no padding, so they index exactly the lanes named. A tick resumes only the
occupied slots (gathered, resumed, copied back) rather than masking all L:
the lanes are independent, so the results are the same and the work
smaller. ``greedy_resume_batch``'s checkpoint semantics make sliced
execution return the one-shot path's results bit for bit: the scheduler
changes when work happens, never what is computed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.corpus import corpus_dim, hot_arm
from ..core.range_search import (
    GreedyState, RangeConfig, greedy_lane_done, greedy_resume_batch,
)
from ..utils import next_pow2


def _put_lanes(pool: GreedyState, idx: torch.Tensor, new: GreedyState) -> None:
    """Write ``new``'s lanes into ``pool`` at slots ``idx``, in place."""
    for f in dataclasses.fields(GreedyState):
        getattr(pool, f.name).index_copy_(0, idx, getattr(new, f.name))


class LaneScheduler:
    """Fixed-width pool of checkpointed greedy lanes over one corpus view.

    Device state, on the corpus's device: the batched ``GreedyState``
    (allocated at the first admit, when its widths are known), the (L, d)
    query matrix and the (L,) radius vector. Host state: the occupancy mask
    and one opaque metadata slot per lane (the server parks the request and
    its phase-1 stats there). ``rebind`` swaps the corpus view and is legal
    only on an empty pool."""

    def __init__(self, corpus, graph, cfg: RangeConfig, n_lanes: int,
                 slice_rounds: int):
        if cfg.mode != "greedy":
            raise ValueError("the lane pool schedules greedy phase-2 work; "
                             f"cfg.mode={cfg.mode!r}")
        self.corpus = corpus
        self.graph = graph
        self.cfg = cfg
        self.n_lanes = next_pow2(max(int(n_lanes), 1))
        self.slice_rounds = max(int(slice_rounds), 1)
        dev = hot_arm(corpus).device
        L = self.n_lanes
        self.queries = torch.zeros((L, corpus_dim(corpus)), dtype=torch.float32, device=dev)
        self.radii = torch.zeros((L,), dtype=torch.float32, device=dev)
        self.gs = None                      # shaped from the first admit
        self.active = np.zeros(L, bool)
        self.meta: list = [None] * L
        self.ticks = 0

    @property
    def device(self) -> torch.device:
        return self.queries.device

    def _index(self, slots) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64), device=self.device)

    # -- occupancy -----------------------------------------------------------
    @property
    def occupancy(self) -> int:
        return int(self.active.sum())

    def free_slots(self) -> np.ndarray:
        return np.nonzero(~self.active)[0]

    # -- epoch advance -------------------------------------------------------
    def rebind(self, corpus, graph) -> None:
        if self.occupancy:
            raise RuntimeError("rebind with in-flight lanes: drain the pool "
                               "before advancing the corpus epoch")
        self.corpus = corpus
        self.graph = graph

    # -- admission -----------------------------------------------------------
    def admit(self, seeded: GreedyState, sel, queries, radii, metas) -> np.ndarray:
        """Place lanes ``sel`` of a seeded batch (``greedy_seed_batch`` over
        a phase-1 dispatch; ``queries``/``radii`` that dispatch's device
        tensors) into free slots. Returns the slots; callers check
        ``free_slots`` first (admission never evicts)."""
        k = len(sel)
        slots = self.free_slots()[:k]
        if len(slots) < k:
            raise RuntimeError(f"admit of {k} lanes into {len(slots)} free slots")
        src, dst = self._index(sel), self._index(slots)
        new = seeded.select(src)
        if self.gs is None:
            self.gs = GreedyState(**{
                f.name: torch.zeros((self.n_lanes,) + tuple(getattr(new, f.name).shape[1:]),
                                    dtype=getattr(new, f.name).dtype, device=self.device)
                for f in dataclasses.fields(GreedyState)})
        _put_lanes(self.gs, dst, new)
        self.queries.index_copy_(0, dst, queries[src])
        self.radii.index_copy_(0, dst, radii[src])
        self.active[slots] = True
        for s, m in zip(slots, metas):
            self.meta[s] = m
        return slots

    # -- deadlines -----------------------------------------------------------
    def expired(self, now: float) -> np.ndarray:
        """Active slots whose lane deadline (``meta["deadline_at"]``, absolute
        seconds on the server's clock; +inf when absent) has strictly
        passed. The server retires these before the next tick, finalizing
        each checkpoint into a certified partial response."""
        out = [int(s) for s in np.nonzero(self.active)[0]
               if now > (self.meta[s] or {}).get("deadline_at", float("inf"))]
        return np.asarray(out, np.int64)

    # -- execution -----------------------------------------------------------
    def tick(self) -> np.ndarray:
        """Advance every active lane ``slice_rounds`` expansions; returns
        the slots whose lanes finished (frontier empty or budget spent)."""
        slots = np.nonzero(self.active)[0]
        if not len(slots):
            return np.zeros(0, np.int64)
        idx = self._index(slots)
        gs = greedy_resume_batch(
            self.corpus, self.graph, self.queries[idx], self.radii[idx],
            self.gs.select(idx), torch.ones(len(slots), dtype=torch.bool, device=self.device),
            self.cfg.result_cap, self.cfg.frontier_rounds, self.slice_rounds,
            self.cfg.search)
        _put_lanes(self.gs, idx, gs)
        self.ticks += 1
        done, _ = greedy_lane_done(gs, self.cfg.frontier_rounds)
        return slots[done]

    def retire(self, slots) -> tuple:
        """Pull lanes out of the pool and free their slots. Returns ``(gs,
        queries, radii, overflow, metas)``: the lanes' states, queries and
        radii (device, one row a slot, in ``slots`` order) and the host
        overflow flags with the one-shot path's end-of-budget bit."""
        slots = np.asarray(slots, np.int64)
        idx = self._index(slots)
        g = self.gs.select(idx)
        _, over = greedy_lane_done(g, self.cfg.frontier_rounds)
        metas = [self.meta[s] for s in slots]
        self.active[slots] = False
        for s in slots:
            self.meta[s] = None
        return g, self.queries[idx], self.radii[idx], over, metas
