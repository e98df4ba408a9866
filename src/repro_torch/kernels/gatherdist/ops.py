"""Dispatch for the row gather + distance.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/gatherdist.cu``, or
``csrc/gatherdist_int8.cu`` for an int8 ``QuantizedCorpus``) or raises.
``use_kernel=False`` forces the plain version on any device.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._launch import (
    ROW_DTYPES, SLACK_FACTOR, check_metric, check_tensor, code_vec, vector_rows)
from .ref import gatherdist_int8_ref, gatherdist_ref

_SMEM_LIMIT = 48 * 1024  # static shared-memory limit of a launch


def gatherdist(points, ids, queries, *, metric: str = "l2",
               use_kernel: bool = True, quantize_query: bool = False):
    """(Q, S) f32 distances from queries[i] to points[ids[i, j]]; INVALID
    or out-of-range ids give +inf. On a ``QuantizedCorpus`` they are
    certified lower bounds, in the f32-query form unless
    ``quantize_query``."""
    if getattr(points, "codes", None) is not None:
        if points.device.type == "cpu" or not use_kernel:
            return gatherdist_int8_ref(points, ids, queries, metric=metric,
                                       quantize_query=quantize_query)
        return gatherdist_int8_cuda(points.codes, points.meta, ids, queries,
                                    metric=metric, quantize_query=quantize_query)
    if points.device.type == "cpu" or not use_kernel:
        return gatherdist_ref(points, ids, queries, metric=metric)
    return gatherdist_cuda(points, ids, queries, metric=metric)


def _check_pairs(rows, ids, queries):
    dev = rows.device
    check_tensor("ids", ids, (torch.int32,), 2, dev)
    check_tensor("queries", queries, (torch.float32,), 2, dev)
    n, d = rows.shape
    qn, s = ids.shape
    if queries.shape != (qn, d):
        raise ValueError(f"queries must be ({qn}, {d}), got "
                         f"{tuple(queries.shape)}")
    return qn, n, d, s


def gatherdist_cuda(points, ids, queries, *, metric: str = "l2"):
    """Launch ``csrc/gatherdist.cu`` on the current stream. ``points``
    (N, d) f32/bf16, ``ids`` (Q, S) int32, ``queries`` (Q, d) f32, all
    contiguous on one CUDA device."""
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"gatherdist_cuda needs CUDA tensors, got {dev}")
    check_tensor("points", points, ROW_DTYPES, 2, dev)
    l2 = check_metric(metric)
    qn, n, d, s = _check_pairs(points, ids, queries)
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


def gatherdist_int8_cuda(codes, meta, ids, queries, *, metric: str = "l2",
                         quantize_query: bool = False,
                         return_dots: bool = False):
    """Launch ``csrc/gatherdist_int8.cu`` on the current stream. ``codes``
    (N, d) int8, ``meta`` (N, 3) f32, ``ids`` (Q, S) int32, ``queries``
    (Q, d) f32, all contiguous on one CUDA device. ``return_dots``
    (int8-query form only) also returns the (Q, S) int32 dots."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"gatherdist_int8_cuda needs CUDA tensors, got {dev}")
    check_tensor("codes", codes, (torch.int8,), 2, dev)
    check_tensor("meta", meta, (torch.float32,), 2, dev)
    if meta.shape != (codes.shape[0], 3):
        raise ValueError(f"meta must be ({codes.shape[0]}, 3), got "
                         f"{tuple(meta.shape)}")
    if return_dots and not quantize_query:
        raise ValueError("the f32-query form takes no int8 dot")
    l2 = check_metric(metric)
    qn, n, d, s = _check_pairs(codes, ids, queries)
    if 8 * 4 * (-(-d // 4) * 4) > _SMEM_LIMIT:  # eight warps' queries
        raise ValueError(f"unsupported gatherdist_int8 dimension d={d}")
    out = torch.empty((qn, s), dtype=torch.float32, device=dev)
    dots = (torch.empty((qn, s), dtype=torch.int32, device=dev)
            if return_dots else None)
    result = (out, dots) if return_dots else out
    if qn * s == 0:
        return result
    lib = _build.load("gatherdist_int8")
    fn = lib.gatherdist_int8_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(codes.data_ptr(), meta.data_ptr(), ids.data_ptr(),
                queries.data_ptr(), out.data_ptr(),
                dots.data_ptr() if return_dots else None,
                qn, n, d, s, l2, int(quantize_query), code_vec(codes),
                SLACK_FACTOR, stream)
    gatherdist_int8_cuda.launches += 1
    _build.check(lib, "gatherdist_int8", rc)
    return result


gatherdist_int8_cuda.launches = 0  # kernel launches since the last reset
