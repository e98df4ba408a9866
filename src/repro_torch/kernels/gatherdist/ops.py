"""Dispatch for the row gather + distance.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/gatherdist.cu``) or raises.
``use_kernel=False`` forces the plain version on any device.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._launch import ROW_DTYPES, check_metric, check_tensor, vector_rows
from .ref import gatherdist_ref


def gatherdist(points, ids, queries, *, metric: str = "l2",
               use_kernel: bool = True):
    """(Q, S) f32 distances from queries[i] to points[ids[i, j]]; INVALID
    or out-of-range ids give +inf."""
    if points.device.type == "cpu" or not use_kernel:
        return gatherdist_ref(points, ids, queries, metric=metric)
    return gatherdist_cuda(points, ids, queries, metric=metric)


def gatherdist_cuda(points, ids, queries, *, metric: str = "l2"):
    """Launch ``csrc/gatherdist.cu`` on the current stream. ``points``
    (N, d) f32/bf16, ``ids`` (Q, S) int32, ``queries`` (Q, d) f32, all
    contiguous on one CUDA device."""
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"gatherdist_cuda needs CUDA tensors, got {dev}")
    check_tensor("points", points, ROW_DTYPES, 2, dev)
    check_tensor("ids", ids, (torch.int32,), 2, dev)
    check_tensor("queries", queries, (torch.float32,), 2, dev)
    l2 = check_metric(metric)
    n, d = points.shape
    qn, s = ids.shape
    if queries.shape != (qn, d):
        raise ValueError(f"queries must be ({qn}, {d}), got "
                         f"{tuple(queries.shape)}")
    out = torch.empty((qn, s), dtype=torch.float32, device=dev)
    if qn * s == 0:
        return out
    lib = _build.load("gatherdist")
    fn = lib.gatherdist_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(points.data_ptr(), ROW_DTYPES[points.dtype], ids.data_ptr(),
                queries.data_ptr(), out.data_ptr(), qn, n, d, s, l2,
                vector_rows(points), stream)
    gatherdist_cuda.launches += 1
    _build.check(lib, "gatherdist", rc)
    return out


gatherdist_cuda.launches = 0  # kernel launches since the last reset
