"""Dispatch for the fused frontier expansion.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/expand.cu``) or raises. ``use_kernel=False``
forces the plain version on any device: it is how a caller times or checks
the kernel against it on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._launch import ROW_DTYPES, check_metric, check_tensor, vector_rows
from .ref import expand_frontier_ref

_SMEM_LIMIT = 48 * 1024  # static shared-memory limit of a launch


def expand_frontier(points, neighbors, frontier, queries, *,
                    metric: str = "l2", use_kernel: bool = True):
    """Returns ``(ids (Q, E*R) int32, dists (Q, E*R) f32, n_dist (Q,)
    int32)``; see ``ref.py`` for the semantics."""
    if points.device.type == "cpu" or not use_kernel:
        return expand_frontier_ref(points, neighbors, frontier, queries,
                                   metric=metric)
    return expand_cuda(points, neighbors, frontier, queries, metric=metric)


def expand_cuda(points, neighbors, frontier, queries, *, metric: str = "l2"):
    """Launch ``csrc/expand.cu`` on the current stream. ``points`` (N, d)
    f32/bf16, ``neighbors`` (N, R) int32, ``frontier`` (Q, E) int32,
    ``queries`` (Q, d) f32, all contiguous on one CUDA device."""
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"expand_cuda needs CUDA tensors, got {dev}")
    check_tensor("points", points, ROW_DTYPES, 2, dev)
    check_tensor("neighbors", neighbors, (torch.int32,), 2, dev)
    check_tensor("frontier", frontier, (torch.int32,), 2, dev)
    check_tensor("queries", queries, (torch.float32,), 2, dev)
    l2 = check_metric(metric)
    n, d = points.shape
    r = neighbors.shape[1]
    qn, e = frontier.shape
    if neighbors.shape[0] != n:
        raise ValueError("neighbors and points disagree on N")
    if queries.shape != (qn, d):
        raise ValueError(f"queries must be ({qn}, {d}), got "
                         f"{tuple(queries.shape)}")
    smem = 4 * d + 4 * (2 * e * r + e)
    if not 1 <= e <= 32 or r < 1 or smem > _SMEM_LIMIT:
        raise ValueError(f"unsupported expand shape E={e}, R={r}, d={d}")
    ids = torch.empty((qn, e * r), dtype=torch.int32, device=dev)
    dists = torch.empty((qn, e * r), dtype=torch.float32, device=dev)
    n_dist = torch.empty((qn,), dtype=torch.int32, device=dev)
    if qn == 0:
        return ids, dists, n_dist
    lib = _build.load("expand")
    fn = lib.expand_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(points.data_ptr(), ROW_DTYPES[points.dtype],
                neighbors.data_ptr(), frontier.data_ptr(), queries.data_ptr(),
                ids.data_ptr(), dists.data_ptr(), n_dist.data_ptr(),
                qn, n, d, r, e, l2, vector_rows(points), stream)
    expand_cuda.launches += 1
    _build.check(lib, "expand", rc)
    return ids, dists, n_dist


expand_cuda.launches = 0  # kernel launches since the last reset
