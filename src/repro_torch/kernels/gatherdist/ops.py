"""Dispatch for the row gather + distance.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/gatherdist.cu``, or
``csrc/gatherdist_int8.cu`` for an int8 ``QuantizedCorpus``) or raises.
``use_kernel=False`` forces the plain version on any device.

The int8 kernel has two routes, chosen by ``plan`` from the shape, the
form, the metric and the alignment alone, never by a failure:

- ``regs``: the f32-query form at l2 (what the main path launches), code
  rows whole 16-byte spans (d % 16 == 0) up to d = 256, code rows and
  queries on 16-byte bases: each warp issues its rows' id, metadata and
  code loads before it reads its query chunks into registers;
- ``warp``: every other shape, form and metric: the query copied (or
  quantized) into shared memory first, then the rows. On an H100 the
  early-issue design tied it in the int8-query form and lost at ip.

The two give the same bits. ``gatherdist_int8_cuda.routes`` counts the
launches of each route.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from .._launch import (
    ROW_DTYPES, SLACK_FACTOR, check_metric, check_tensor, code_vec, count_launch,
    vector_rows)
from .ref import gatherdist_int8_ref, gatherdist_ref

_SMEM_LIMIT = 48 * 1024  # static shared-memory limit of a launch
WARPS = 8                # csrc/gatherdist_int8.cu's: a query a warp, both routes
REGS_MAX_D = 256         # the regs route's widest rows: two 16-byte chunks a lane


class GatherPlan(NamedTuple):
    route: str    # "regs" or "warp"
    blocks: int   # blocks of WARPS warps, one query a warp
    threads: int  # threads a block


def plan(q: int, d: int, *, aligned: bool = True, metric: str = "l2",
         quantize_query: bool = False) -> GatherPlan:
    """The int8 kernel's route and grid for Q queries over (N, d) codes,
    where the code rows and the queries start (``aligned``) or not on a
    16-byte boundary: ``regs`` for the f32-query form at l2 over rows of
    whole 16-byte spans up to ``REGS_MAX_D``, else ``warp``; one query a
    warp either way."""
    if q < 0 or d < 1:
        raise ValueError(f"unsupported gatherdist_int8 shape Q={q}, d={d}")
    check_metric(metric)
    regs = (metric == "l2" and not quantize_query and aligned and d % 16 == 0
            and d <= REGS_MAX_D)
    return GatherPlan("regs" if regs else "warp", -(-q // WARPS), 32 * WARPS)


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
    count_launch(gatherdist_cuda)
    _build.check(lib, "gatherdist", rc)
    return out


gatherdist_cuda.launches = 0  # kernel launches since the last reset


def gatherdist_int8_cuda(codes, meta, ids, queries, *, metric: str = "l2",
                         quantize_query: bool = False,
                         return_dots: bool = False, route: str | None = None):
    """Launch ``csrc/gatherdist_int8.cu`` on the current stream. ``codes``
    (N, d) int8, ``meta`` (N, 3) f32, ``ids`` (Q, S) int32, ``queries``
    (Q, d) f32, all contiguous on one CUDA device. ``return_dots``
    (int8-query form only) also returns the (Q, S) int32 dots. ``route``
    None takes ``plan``'s; ``"warp"`` forces the first kernel (to time it
    on the same inputs); naming ``regs`` where the plan says ``warp``
    raises."""
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
    aligned = code_vec(codes) == 16 and queries.data_ptr() % 16 == 0
    p = plan(qn, d, aligned=aligned, metric=metric, quantize_query=quantize_query)
    if route == "warp":
        p = p._replace(route="warp")
    elif route not in (None, p.route):
        raise ValueError(f"route {route!r} cannot take this gather "
                         f"(plan: {p.route})")
    if p.route == "warp" and WARPS * 4 * (-(-d // 4) * 4) > _SMEM_LIMIT:
        raise ValueError(f"unsupported gatherdist_int8 dimension d={d}")
    out = torch.empty((qn, s), dtype=torch.float32, device=dev)
    dots = (torch.empty((qn, s), dtype=torch.int32, device=dev)
            if return_dots else None)
    result = (out, dots) if return_dots else out
    if qn * s == 0:
        return result
    lib = _build.load("gatherdist_int8")
    if p.route == "regs":
        fn = lib.gatherdist_int8_regs_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        args = [codes.data_ptr(), meta.data_ptr(), ids.data_ptr(),
                queries.data_ptr(), out.data_ptr(), qn, n, d, s]
    else:
        fn = lib.gatherdist_int8_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        args = [codes.data_ptr(), meta.data_ptr(), ids.data_ptr(),
                queries.data_ptr(), out.data_ptr(),
                dots.data_ptr() if return_dots else None,
                qn, n, d, s, l2, int(quantize_query), code_vec(codes)]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, SLACK_FACTOR, stream)
    count_launch(gatherdist_int8_cuda, p.route)
    _build.check(lib, "gatherdist_int8", rc)
    return result


gatherdist_int8_cuda.launches = 0  # kernel launches since the last reset
gatherdist_int8_cuda.routes = {"regs": 0, "warp": 0}  # the same, by route
