"""Dispatch for the fused frontier expansion.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/expand.cu``, or ``csrc/expand_int8.cu`` for
an int8 ``QuantizedCorpus``) or raises. ``use_kernel=False`` forces the
plain version on any device: it is how a caller times or checks the kernel
against it on the card.

Each kernel has two routes, chosen by ``plan`` from the shape, the dtype
and the alignment alone, never by a failure:

- ``bulk``: rows that are whole 16-byte spans on a 16-byte base (d % 4 ==
  0 for f32, d % 8 == 0 for bf16, d % 16 == 0 for int8 codes), R % 4 == 0,
  and a stage that fits shared memory. Persistent one-warp blocks, as
  many as shared memory holds (``bulk_launch`` shapes each launch); each
  deduplicates its queries' tiles in one linear pass, gathers the kept
  rows into its stages in shared memory by 1-D bulk copy, and takes the
  distances there (``csrc/expand_bulk.cuh``);
- ``warp``: every other shape: one block per query, one warp per frontier
  slot, rows read from device memory.

The two give the same bits. ``expand_cuda.routes`` and
``expand_int8_cuda.routes`` count the launches of each route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from .._launch import (
    ROW_DTYPES, SLACK_FACTOR, check_metric, check_tensor, code_vec, count_launch,
    vector_rows)
from .ref import expand_frontier_int8_ref, expand_frontier_ref

_SMEM_LIMIT = 48 * 1024  # static shared-memory limit of a warp-route launch
# csrc/expand_bulk.cuh's geometry
TB, FR = 3, 5              # adjacency tile buffers, frontier ring
SMEM_PER_SM = 233_472      # H100: 228 KB of shared memory an SM ...
SMEM_PER_BLOCK = 232_448   # ... at most 227 KB of it a block ...
SMEM_RESERVED = 1024       # ... and 1 KB of each resident block the runtime's
MAX_BLOCKS_PER_SM = 32     # resident blocks an SM


class ExpandPlan(NamedTuple):
    route: str   # "bulk" or "warp"
    smem: int    # shared memory of a block (bulk: at one stage)


class BulkLaunch(NamedTuple):
    blocks: int  # persistent one-warp blocks
    stages: int  # ring stages a block
    split: int   # warps a query
    smem: int    # shared memory of a block


def _up16(b: int) -> int:
    return (b + 15) & ~15


def bulk_smem(e: int, r: int, d: int, row_bytes: int, int8: bool,
              stages: int) -> int:
    """Dynamic shared memory of one bulk-route block: barriers, frontier
    ring, adjacency tiles, kept ids, dedup table, int8 query codes, and
    ``stages`` stages of R ids, the query and R rows (and R metadata rows
    for int8). ``expand_bulk.cuh::geometry`` in bytes."""
    t = e * r
    hs = 32
    while hs < 4 * t:
        hs <<= 1
    fixed = (_up16(8 * (TB + stages)) + _up16(4 * FR * e) + _up16(4 * TB * t)
             + _up16(4 * t) + 4 * hs + (_up16(d) if int8 else 0))
    stage = (16 + _up16(4 * r) + _up16(4 * d) + (_up16(12 * r) if int8 else 0)
             + r * row_bytes)
    return fixed + stages * stage


def warp_smem(e: int, r: int, d: int) -> int:
    """Shared memory of one warp-route block: the f32 query, two tiles of
    E*R ids and E counts."""
    return 4 * d + 4 * (2 * e * r + e)


def plan(e: int, r: int, d: int, dtype: torch.dtype, *,
         aligned: bool = True) -> ExpandPlan:
    """The route for frontiers of E slots over (N, d) rows of ``dtype``
    (float32, bfloat16, or int8 codes) with R neighbours a node, where the
    rows, the adjacency rows and the queries start (``aligned``) or not on
    a 16-byte boundary: ``bulk`` where a block's shared memory at one stage
    fits, else ``warp``."""
    if not 1 <= e <= 32 or r < 1 or d < 1:
        raise ValueError(f"unsupported expand shape E={e}, R={r}, d={d}")
    row_bytes = d * torch.empty((), dtype=dtype).element_size()
    if aligned and row_bytes % 16 == 0 and r % 4 == 0:
        smem = bulk_smem(e, r, d, row_bytes, dtype == torch.int8, 1)
        if smem <= SMEM_PER_BLOCK:
            return ExpandPlan("bulk", smem)
    return ExpandPlan("warp", warp_smem(e, r, d))


def blocks_per_sm(smem: int) -> int:
    """One-warp blocks of ``smem`` bytes of shared memory an SM holds."""
    if smem > SMEM_PER_BLOCK:
        return 0
    return min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))


def bulk_launch(qn: int, e: int, r: int, d: int, row_bytes: int, int8: bool,
                sms: int) -> BulkLaunch:
    """The shape of a bulk launch of Q queries on a card of ``sms`` SMs.
    When the queries are fewer than the warps the card holds, ``split``
    warps share each query (up to E; each takes the frontier slots e = part
    mod split) and, where the card still holds them, each warp gets a stage
    for every slot it takes, so they are in flight together; otherwise one
    stage a warp (measured fastest on an H100). The Q * split units go to
    as few warps as give every warp the same number of units as a full
    card would."""
    def cap(stages):
        return blocks_per_sm(bulk_smem(e, r, d, row_bytes, int8, stages)) * sms

    split = max(1, min(e, cap(1) // max(qn, 1)))
    slots = -(-e // split)
    stages = max(s for s in range(1, slots + 1)
                 if s == 1 or qn * split <= cap(s))
    units = qn * split
    per_block = -(-units // cap(stages))
    return BulkLaunch(-(-units // per_block), stages, split,
                      bulk_smem(e, r, d, row_bytes, int8, stages))


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
    """Shape checks shared by both kernels; returns (Q, N, d, R, E)."""
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
    if not 1 <= e <= 32 or r < 1:
        raise ValueError(f"unsupported expand shape E={e}, R={r}, d={d}")
    return qn, n, d, r, e


def _route(rows, neighbors, queries, e: int, r: int, d: int,
           route: str | None) -> ExpandPlan:
    """``plan``'s route for these tensors, or the one ``route`` names:
    ``warp`` takes any shape its shared memory holds; naming ``bulk`` where
    the plan says ``warp`` raises."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (rows, neighbors, queries))
    p = plan(e, r, d, rows.dtype, aligned=aligned)
    if route == "warp":
        p = ExpandPlan("warp", warp_smem(e, r, d))
    elif route not in (None, p.route):
        raise ValueError(f"route {route!r} cannot take this expansion "
                         f"(plan: {p.route})")
    if p.route == "warp" and p.smem > _SMEM_LIMIT:
        raise ValueError(f"unsupported expand shape E={e}, R={r}, d={d}")
    return p


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_SMEM_CHECKED: set = set()


def _bulk_args(lib, prefix: str, qn: int, e: int, r: int, d: int,
               row_bytes: int, int8: bool, dev) -> list[int]:
    """[blocks, stages, split] of a bulk launch, after holding the plan's
    shared memory to the library's layout once per shape."""
    sms = _sms(dev.index if dev.index is not None else torch.cuda.current_device())
    b = bulk_launch(qn, e, r, d, row_bytes, int8, sms)
    key = (prefix, e, r, d, row_bytes, b.stages)
    if key not in _SMEM_CHECKED:
        fn = getattr(lib, f"{prefix}_bulk_smem")
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_int
        got = fn(e, r, d, row_bytes, int(int8), b.stages)
        if got != b.smem:
            raise RuntimeError(f"{prefix}: the kernel's layout takes {got} bytes "
                               f"of shared memory, ops.py's {b.smem}")
        _SMEM_CHECKED.add(key)
    return [b.blocks, b.stages, b.split]


def expand_cuda(points, neighbors, frontier, queries, *, metric: str = "l2",
                route: str | None = None):
    """Launch ``csrc/expand.cu`` on the current stream. ``points`` (N, d)
    f32/bf16, ``neighbors`` (N, R) int32, ``frontier`` (Q, E) int32,
    ``queries`` (Q, d) f32, all contiguous on one CUDA device. ``route``
    None takes ``plan``'s; ``"warp"`` forces the warp route (to time it on
    the same inputs)."""
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"expand_cuda needs CUDA tensors, got {dev}")
    check_tensor("points", points, ROW_DTYPES, 2, dev)
    l2 = check_metric(metric)
    qn, n, d, r, e = _check_expand(points, neighbors, frontier, queries)
    p = _route(points, neighbors, queries, e, r, d, route)
    ids = torch.empty((qn, e * r), dtype=torch.int32, device=dev)
    dists = torch.empty((qn, e * r), dtype=torch.float32, device=dev)
    n_dist = torch.empty((qn,), dtype=torch.int32, device=dev)
    if qn == 0:
        return ids, dists, n_dist
    lib = _build.load("expand")
    ptrs = [points.data_ptr(), ROW_DTYPES[points.dtype], neighbors.data_ptr(),
            frontier.data_ptr(), queries.data_ptr(), ids.data_ptr(),
            dists.data_ptr(), n_dist.data_ptr(), qn, n, d, r, e, l2]
    if p.route == "bulk":
        fn = lib.expand_bulk_launch
        tail = _bulk_args(lib, "expand", qn, e, r, d, d * points.element_size(),
                          False, dev)
    else:
        fn = lib.expand_launch
        tail = [vector_rows(points)]
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * (6 + len(tail)) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, *tail, stream)
    count_launch(expand_cuda, p.route)
    _build.check(lib, "expand", rc)
    return ids, dists, n_dist


expand_cuda.launches = 0  # kernel launches since the last reset
expand_cuda.routes = {"bulk": 0, "warp": 0}  # the same, by route


def expand_int8_cuda(codes, meta, neighbors, frontier, queries, *,
                     metric: str = "l2", quantize_query: bool = False,
                     return_dots: bool = False, route: str | None = None):
    """Launch ``csrc/expand_int8.cu`` on the current stream. ``codes``
    (N, d) int8, ``meta`` (N, 3) f32, ``neighbors`` (N, R) int32,
    ``frontier`` (Q, E) int32, ``queries`` (Q, d) f32, all contiguous on
    one CUDA device. ``return_dots`` (int8-query form only) appends the
    (Q, E*R) int32 dots. ``route`` as ``expand_cuda``'s."""
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
    p = _route(codes, neighbors, queries, e, r, d, route)
    ids = torch.empty((qn, e * r), dtype=torch.int32, device=dev)
    dists = torch.empty((qn, e * r), dtype=torch.float32, device=dev)
    n_dist = torch.empty((qn,), dtype=torch.int32, device=dev)
    dots = (torch.empty((qn, e * r), dtype=torch.int32, device=dev)
            if return_dots else None)
    out = (ids, dists, n_dist) + ((dots,) if return_dots else ())
    if qn == 0:
        return out
    lib = _build.load("expand_int8")
    ptrs = [codes.data_ptr(), meta.data_ptr(), neighbors.data_ptr(),
            frontier.data_ptr(), queries.data_ptr(), ids.data_ptr(),
            dists.data_ptr(), n_dist.data_ptr(),
            dots.data_ptr() if return_dots else None,
            qn, n, d, r, e, l2, int(quantize_query)]
    if p.route == "bulk":
        fn = lib.expand_int8_bulk_launch
        tail = [SLACK_FACTOR] + _bulk_args(lib, "expand_int8", qn, e, r, d, d,
                                           True, dev)
        types = [ctypes.c_float] + [ctypes.c_int] * 3
    else:
        fn = lib.expand_int8_launch
        tail = [code_vec(codes), SLACK_FACTOR]
        types = [ctypes.c_int, ctypes.c_float]
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + types
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, *tail, stream)
    count_launch(expand_int8_cuda, p.route)
    _build.check(lib, "expand_int8", rc)
    return out


expand_int8_cuda.launches = 0  # kernel launches since the last reset
expand_int8_cuda.routes = {"bulk": 0, "warp": 0}  # the same, by route
