"""Segment ops: the GNN's message passing over an edge list, as the
reference's ``layers/segment.py``: gather by source, transform, scatter by
destination, with degree normalization and padding edges (an endpoint < 0)
dropped into an extra segment that is cut off.

Sum and mean scatter with ``index_add``, max with ``scatter_reduce("amax",
include_self=False)`` (a destination with no message reads 0, as the
reference turns its -inf into 0). On the card ``index_add`` adds with
atomics, in an order that changes from run to run, so an f32 sum there
agrees with the CPU's (and the reference's) within a tolerance, not to the
bit. Degrees are sums of ones, exact in any order.
"""
from __future__ import annotations

import torch


def _valid(edge_src: torch.Tensor, edge_dst: torch.Tensor) -> torch.Tensor:
    return (edge_src >= 0) & (edge_dst >= 0)


def gather_scatter(node_feats: torch.Tensor, edge_src, edge_dst, num_nodes: int, *,
                   agg: str = "sum", edge_weight=None) -> torch.Tensor:
    """node_feats (N, d), edges (E,) int (-1 padding), ``agg`` sum | mean |
    max, ``edge_weight`` (E,) -> (N, d): each destination's aggregate of
    its sources' (weighted) features."""
    dev = node_feats.device
    src = torch.as_tensor(edge_src, device=dev).long()
    dst = torch.as_tensor(edge_dst, device=dev).long()
    valid = _valid(src, dst)
    src = torch.where(valid, src, 0)
    dst = torch.where(valid, dst, num_nodes)      # padding -> the cut segment
    msg = node_feats[src]
    if edge_weight is not None:
        msg = msg * torch.as_tensor(edge_weight, device=dev)[:, None].to(msg.dtype)
    d = node_feats.shape[1]
    if agg == "max":
        msg = torch.where(valid[:, None], msg, float("-inf"))
        init = torch.full((num_nodes + 1, d), float("-inf"), dtype=msg.dtype, device=dev)
        out = init.scatter_reduce(0, dst[:, None].expand(-1, d), msg, "amax",
                                  include_self=False)[:num_nodes]
        return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype,
                                                                  device=dev))
    msg = torch.where(valid[:, None], msg, torch.zeros((), dtype=msg.dtype, device=dev))
    out = torch.zeros((num_nodes + 1, d), dtype=msg.dtype, device=dev).index_add(
        0, dst, msg)[:num_nodes]
    if agg == "mean":
        deg = torch.zeros(num_nodes + 1, device=dev).index_add(
            0, dst, valid.float())[:num_nodes]
        out = out / torch.clamp(deg, min=1.0)[:, None]
    return out


def sym_norm_weights(edge_src, edge_dst, num_nodes: int) -> torch.Tensor:
    """GCN's symmetric normalization, 1/sqrt(deg_out[src] * deg_in[dst])
    with each degree counting a self loop (+1); 0 on padding edges."""
    src = torch.as_tensor(edge_src).long()
    dst = torch.as_tensor(edge_dst, device=src.device).long()
    valid = _valid(src, dst)
    ones = valid.float()
    src = torch.where(valid, src, 0)
    dst = torch.where(valid, dst, 0)
    deg = torch.zeros(num_nodes, device=src.device).index_add(0, dst, ones) + 1.0
    deg_out = torch.zeros(num_nodes, device=src.device).index_add(0, src, ones) + 1.0
    w = (deg_out[src] * deg[dst]) ** -0.5
    return torch.where(valid, w, torch.zeros((), device=src.device))
