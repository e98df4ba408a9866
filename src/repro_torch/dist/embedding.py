"""Row-sharded embedding lookup over the mesh.

The recsys (F, V, d) field tables are the largest arrays of the system.
They shard over the *vocab* row axis across the mesh; a lookup becomes:
every rank resolves the ids that land in its row range and contributes
zeros elsewhere, and one ``all_reduce`` over the ranks that hold the table
assembles the full (B, F, d) activation.
"""
from __future__ import annotations

import torch

from ._comm import all_reduce_sum, axis_group
from .sharding import _axis_size


def sharded_lookup(mesh, tables: torch.Tensor, idx, *, axis=("data", "model")) -> torch.Tensor:
    """``tables`` is this rank's (F, V / n, d) row block of the (F, V, d)
    tables, row-sharded over ``axis`` (one mesh axis name, or a tuple of
    every axis: V over their product, major-to-minor in tuple order); ``idx``
    (B, F) global row ids, the same on every rank -> (B, F, d) on every
    rank."""
    axes = axis if isinstance(axis, tuple) else (axis,)
    lin = 0  # this rank's block: its linear index in tuple order
    for a in axes:
        lin = lin * _axis_size(mesh, a) + int(mesh.get_local_rank(a))
    v_local = tables.shape[1]
    ix = torch.as_tensor(idx, device=tables.device).long()
    loc = ix - lin * v_local
    valid = (loc >= 0) & (loc < v_local)
    safe = torch.where(valid, loc, 0)
    fields = torch.arange(tables.shape[0], device=tables.device)
    rows = tables[fields[None, :], safe]                       # (B, F, d)
    rows = torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))
    return all_reduce_sum(rows, axis_group(mesh, axes))
