"""Dispatch for the fused frontier expansion.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/expand.cu``, or ``csrc/expand_int8.cu`` for
an int8 ``QuantizedCorpus``) or raises. ``use_kernel=False`` forces the
plain version on any device: it is how a caller times or checks the kernel
against it on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._launch import (
    ROW_DTYPES, SLACK_FACTOR, check_metric, check_tensor, code_vec, vector_rows)
from .ref import expand_frontier_int8_ref, expand_frontier_ref

_SMEM_LIMIT = 48 * 1024  # static shared-memory limit of a launch


def expand_frontier(points, neighbors, frontier, queries, *,
                    metric: str = "l2", use_kernel: bool = True,
                    quantize_query: bool = False):
    """Returns ``(ids (Q, E*R) int32, dists (Q, E*R) f32, n_dist (Q,)
    int32)``; see ``ref.py`` for the semantics. ``points`` is an (N, d)
    f32/bf16 tensor or a ``QuantizedCorpus``; on the latter
    ``quantize_query`` picks the int8-query form over the f32-query form.
    On an f32/bf16 corpus it changes nothing: that kernel computes the diff
    form either way."""
    if getattr(points, "codes", None) is not None:
        if points.device.type == "cpu" or not use_kernel:
            return expand_frontier_int8_ref(points, neighbors, frontier, queries,
                                            metric=metric,
                                            quantize_query=quantize_query)
        return expand_int8_cuda(points.codes, points.meta, neighbors, frontier,
                                queries, metric=metric,
                                quantize_query=quantize_query)
    if points.device.type == "cpu" or not use_kernel:
        return expand_frontier_ref(points, neighbors, frontier, queries,
                                   metric=metric)
    return expand_cuda(points, neighbors, frontier, queries, metric=metric)


def _check_expand(rows, neighbors, frontier, queries):
    """Shape checks shared by both kernels (each holds the query in 4 d
    bytes of shared memory beside its tile); returns (Q, N, d, R, E)."""
    dev = rows.device
    check_tensor("neighbors", neighbors, (torch.int32,), 2, dev)
    check_tensor("frontier", frontier, (torch.int32,), 2, dev)
    check_tensor("queries", queries, (torch.float32,), 2, dev)
    n, d = rows.shape
    r = neighbors.shape[1]
    qn, e = frontier.shape
    if neighbors.shape[0] != n:
        raise ValueError("neighbors and the corpus disagree on N")
    if queries.shape != (qn, d):
        raise ValueError(f"queries must be ({qn}, {d}), got "
                         f"{tuple(queries.shape)}")
    smem = 4 * d + 4 * (2 * e * r + e)
    if not 1 <= e <= 32 or r < 1 or smem > _SMEM_LIMIT:
        raise ValueError(f"unsupported expand shape E={e}, R={r}, d={d}")
    return qn, n, d, r, e


def expand_cuda(points, neighbors, frontier, queries, *, metric: str = "l2"):
    """Launch ``csrc/expand.cu`` on the current stream. ``points`` (N, d)
    f32/bf16, ``neighbors`` (N, R) int32, ``frontier`` (Q, E) int32,
    ``queries`` (Q, d) f32, all contiguous on one CUDA device."""
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"expand_cuda needs CUDA tensors, got {dev}")
    check_tensor("points", points, ROW_DTYPES, 2, dev)
    l2 = check_metric(metric)
    qn, n, d, r, e = _check_expand(points, neighbors, frontier, queries)
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


def expand_int8_cuda(codes, meta, neighbors, frontier, queries, *,
                     metric: str = "l2", quantize_query: bool = False,
                     return_dots: bool = False):
    """Launch ``csrc/expand_int8.cu`` on the current stream. ``codes``
    (N, d) int8, ``meta`` (N, 3) f32, ``neighbors`` (N, R) int32,
    ``frontier`` (Q, E) int32, ``queries`` (Q, d) f32, all contiguous on
    one CUDA device. ``return_dots`` (int8-query form only) appends the
    (Q, E*R) int32 dots."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"expand_int8_cuda needs CUDA tensors, got {dev}")
    check_tensor("codes", codes, (torch.int8,), 2, dev)
    check_tensor("meta", meta, (torch.float32,), 2, dev)
    if meta.shape != (codes.shape[0], 3):
        raise ValueError(f"meta must be ({codes.shape[0]}, 3), got "
                         f"{tuple(meta.shape)}")
    if return_dots and not quantize_query:
        raise ValueError("the f32-query form takes no int8 dot")
    l2 = check_metric(metric)
    qn, n, d, r, e = _check_expand(codes, neighbors, frontier, queries)
    ids = torch.empty((qn, e * r), dtype=torch.int32, device=dev)
    dists = torch.empty((qn, e * r), dtype=torch.float32, device=dev)
    n_dist = torch.empty((qn,), dtype=torch.int32, device=dev)
    dots = (torch.empty((qn, e * r), dtype=torch.int32, device=dev)
            if return_dots else None)
    out = (ids, dists, n_dist) + ((dots,) if return_dots else ())
    if qn == 0:
        return out
    lib = _build.load("expand_int8")
    fn = lib.expand_int8_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(codes.data_ptr(), meta.data_ptr(), neighbors.data_ptr(),
                frontier.data_ptr(), queries.data_ptr(), ids.data_ptr(),
                dists.data_ptr(), n_dist.data_ptr(),
                dots.data_ptr() if return_dots else None,
                qn, n, d, r, e, l2, int(quantize_query), code_vec(codes),
                SLACK_FACTOR, stream)
    expand_int8_cuda.launches += 1
    _build.check(lib, "expand_int8", rc)
    return out


expand_int8_cuda.launches = 0  # kernel launches since the last reset
