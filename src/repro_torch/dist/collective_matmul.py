"""Decomposed collective matmuls: ring schedules over one mesh axis.

All-gather-then-matmul and matmul-then-reduce-scatter run as two serial
steps when written plainly. The ring decompositions here interleave one
chunk of compute with one hop per step (one ``batch_isend_irecv`` over the
axis group's ranks), which is what lets a transfer overlap the next chunk's
product. Every rank of the mesh calls them with its local blocks:

* ``allgather_matmul``: x row-sharded, w replicated -> the full (M, F)
  output on every rank; each step multiplies the chunk it holds and passes
  it along the ring.
* ``matmul_reducescatter``: x col-sharded, w row-sharded -> the summed rows
  of this rank's chunk; each step adds the local contribution for one
  destination and forwards the accumulator.

The products are ``torch.matmul``, as the reference's are ``@``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ._comm import axis_group, ring_shift


def _axis(mesh, axis_name: str, n: int):
    group = axis_group(mesh, axis_name)
    if dist.get_world_size(group) != n:
        raise ValueError(f"axis {axis_name!r} has {dist.get_world_size(group)} ranks, not {n}")
    return group, dist.get_rank(group)


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, *, axis_name: str, n: int,
                     mesh) -> torch.Tensor:
    """x local (M/n, K) row-shard, w (K, F) replicated -> (M, F) on every
    rank. Equal to ``all_gather(x) @ w``, decomposed so chunk ``i``'s
    product overlaps the ring transfer of chunk ``i + 1``."""
    group, idx = _axis(mesh, axis_name, n)
    m = x.shape[0]
    out = torch.zeros((n * m, w.shape[-1]), dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    chunk = x
    for step in range(n):
        src = (idx - step) % n  # ring: the rank this chunk started on
        out[src * m:(src + 1) * m] = torch.matmul(chunk, w)
        if step < n - 1:
            chunk = ring_shift(chunk, group)
    return out


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, *, axis_name: str, n: int,
                         mesh) -> torch.Tensor:
    """x local (M, K/n), w local (K/n, F) -> (M/n, F), this rank's rows.
    Equal to a reduce-scatter of ``x @ w``: the local partial product is
    chunked over rows and ring-reduced, so each rank ends with the fully
    summed chunk of its own rows."""
    group, idx = _axis(mesh, axis_name, n)
    partial = torch.matmul(x, w)          # (M, F) partial sum over K
    m = partial.shape[0] // n

    def chunk_for(dest: int) -> torch.Tensor:
        return partial[dest * m:(dest + 1) * m]

    # the destination visited at step t is (idx - t - 1) mod n; after n - 1
    # hops the accumulator sits on its destination with all n contributions
    acc = chunk_for((idx - 1) % n)
    for t in range(1, n):
        acc = ring_shift(acc, group)
        acc = acc + chunk_for((idx - t - 1) % n)
    return acc
