"""The table of peaks and the operations and bytes each kernel launch
needs, for the roofline shares.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full
700 W): HBM3 at 3.35 TB/s, 67 TFLOP/s of float32 outside the tensor cores.
A launch's bound is the larger of its least bytes over the memory rate and
its operations over the compute rate; a kernel's share is the sum of its
launches' bounds over the sum of their device times. Bytes count what the
launch's inputs need, each once: a reading can never pass 100 % because a
launch moved more than it had to.
"""
from __future__ import annotations

import torch

PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12}


def bound_s(n_bytes: float, flops: float, rate: float = PEAKS["f32_flops"]) -> float:
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], flops / rate)


def expand_cost(ids: torch.Tensor, frontier: torch.Tensor, nbrs: torch.Tensor,
                queries: torch.Tensor, row_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of one frontier expansion, from a frozen copy of
    ``chip_smoke.py::expand_bytes`` narrowed to the least: each distinct
    kept row once (``row_bytes`` each), each distinct frontier node's
    adjacency row once, the frontier, the query of each lane that has a
    live frontier slot, and the outputs (ids and distances of every slot,
    one count a lane). Operations: three a dimension of each kept pair
    (difference, product, sum)."""
    n, r = nbrs.shape
    invalid = (ids < 0) | (ids >= n)
    kept = ids[~invalid]
    live = (frontier >= 0) & (frontier < n)
    d = queries.shape[1]
    n_bytes = (torch.unique(kept).numel() * row_bytes
               + torch.unique(frontier[live]).numel() * r * 4
               + frontier.numel() * 4
               + int(live.any(1).sum()) * d * 4
               + ids.numel() * 8 + frontier.shape[0] * 4)
    return n_bytes, kept.numel() * d * 3


def rerank_cost(ids: torch.Tensor, lanes: torch.Tensor, d: int) -> tuple[int, int]:
    """(bytes, operations) of one guard-band rerank, as ``chip_smoke.py``'s
    rerank bound counts it: each distinct f32 row and each distinct query
    once, each pair's id and lane read and its distance written; three
    operations a dimension of each pair."""
    p = ids.numel()
    return ((torch.unique(ids).numel() + torch.unique(lanes).numel()) * d * 4 + p * 12,
            p * d * 3)


def roofline(ctx, name: str, owner: str):
    """A roofline reader's share in %: the summed bounds its hook counted
    (``ctx.costs[name]``) over the device time of ``owner``'s kernels in
    the trace; None where there is no trace, no launch, or the trace and
    the counting run disagree on the number of launches."""
    if ctx.trace is None or name not in ctx.costs:
        return None
    launches, bound = ctx.costs[name]
    traced, seconds = ctx.trace.owner_time(owner, ctx.owners)
    if launches == 0 or traced != launches or seconds <= 0:
        return None
    return 100.0 * bound / seconds
