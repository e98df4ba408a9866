"""Dispatch for the rerank-fetch kernel.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/rerank_fetch.cu``) or raises.
``use_kernel=False`` forces the plain version on any device.

The kernel has two routes; ``plan`` picks one from the shape and the
alignment alone, never by a failure:

- ``regs``: at least ``REGS_MIN_PAIRS`` pairs over rows and queries of
  whole 16-byte spans (d % 4 == 0) up to d = 256 on 16-byte bases:
  persistent blocks, as many as the card holds, that take 32 pairs a warp
  at a time and keep four rows a group of 8 lanes in registers before
  summing them, the query kept across a run of equal lanes;
- ``warp``: every other shape: one warp a pair. Below ``REGS_MIN_PAIRS``
  it is faster than ``regs``, whose warps walk their 32 pairs in turn
  while the card has warps to spare.

``rerank_fetch_cuda.routes`` counts the launches of each route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._launch import check_metric, check_tensor, count_launch, vector_rows
from .ref import fetch_rerank_pairs_ref

CHUNK = 32      # pairs a warp takes at a time
WARPS = 8       # csrc/rerank_fetch.cu's regs route: warps a block
MAX_D = 256     # the regs route's widest rows
# fewer pairs run faster one warp a pair: on an H100 the two routes cross
# between 16,384 and 24,576 lane-major pairs, the order the band arrives in
# (chip_smoke.py's [kernel] rerank_fetch lines); the main path's bands hold
# 35k-240k
REGS_MIN_PAIRS = 24_576


def persistent_rows(d: int, aligned: bool = True) -> bool:
    """Whether the regs route takes (N, d) f32 rows and (Q, d)
    queries whose bases are (``aligned``) or are not on a 16-byte
    boundary: rows of whole 16-byte spans up to ``MAX_D``."""
    return aligned and d % 4 == 0 and d <= MAX_D


def plan(p: int, d: int, *, aligned: bool = True) -> str:
    """The route for P pairs over (N, d) f32 rows and (Q, d) queries:
    ``regs`` where ``persistent_rows`` and P >= ``REGS_MIN_PAIRS``, else
    ``warp``."""
    if p < 0 or d < 1:
        raise ValueError(f"unsupported rerank_fetch shape P={p}, d={d}")
    return "regs" if persistent_rows(d, aligned) and p >= REGS_MIN_PAIRS else "warp"


def persistent_blocks(p: int, sms: int, per_sm: int) -> int:
    """Blocks of a regs launch over P pairs: as many as the card holds
    (``per_sm`` blocks on each of ``sms`` SMs), but no more than the pairs'
    chunks of ``CHUNK`` fill. Warp w of the grid takes chunks w, w +
    blocks * WARPS, ..."""
    chunks = -(-p // CHUNK)
    return min(-(-chunks // WARPS), sms * per_sm)


def fetch_rerank_pairs(raw, queries, ids, lanes, *, metric: str = "l2",
                       use_kernel: bool = True):
    """(P,) exact f32 distances between raw[ids[p]] and queries[lanes[p]]
    (ids clipped to [0, N), lanes to [0, Q)): the guard-band rerank's exact
    pass, with the query rows read in place."""
    if raw.device.type == "cpu" or not use_kernel:
        return fetch_rerank_pairs_ref(raw, queries, ids, lanes, metric)
    return rerank_fetch_cuda(raw, queries, ids, lanes, metric=metric)


def fetch_rerank_dists(raw, ids, qv, *, metric: str = "l2",
                       use_kernel: bool = True):
    """The reference's signature, ``qv`` (P, d) holding each pair's query
    row: the pairs with identity lanes. P need not be a multiple of a
    tile."""
    lanes = torch.arange(qv.shape[0], dtype=torch.int32, device=qv.device)
    return fetch_rerank_pairs(raw, qv, ids, lanes, metric=metric,
                              use_kernel=use_kernel)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _per_sm(index: int, d: int) -> int:
    """Blocks of the regs route an SM of device ``index`` holds at d, by
    the runtime's occupancy query."""
    lib = _build.load("rerank_fetch")
    fn = lib.rerank_fetch_blocks_per_sm
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    with torch.cuda.device(index):
        per_sm = fn(d)
    if per_sm < 1:
        raise RuntimeError(f"rerank_fetch: the regs route fits no block on an "
                           f"SM at d={d} ({per_sm})")
    return per_sm


def launch_grid(p: int, d: int, route: str, device) -> tuple[int, int]:
    """(blocks, threads a block) of a launch of ``route`` over P pairs at d
    on ``device`` (the ``warp`` route: one warp a pair, eight a block)."""
    if route == "warp":
        return -(-p // 8), 256
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return persistent_blocks(p, _sms(index), _per_sm(index, d)), 32 * WARPS


def rerank_fetch_cuda(raw, queries, ids, lanes, *, metric: str = "l2",
                      route: str | None = None):
    """Launch ``csrc/rerank_fetch.cu`` on the current stream. ``raw``
    (N, d) f32, ``queries`` (Q, d) f32, ``ids`` and ``lanes`` (P,) int32,
    all contiguous on one CUDA device. ``route`` None takes ``plan``'s;
    another forces that route on the same inputs (to time it), and naming
    ``regs`` for rows it cannot take raises."""
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"rerank_fetch_cuda needs CUDA tensors, got {dev}")
    check_tensor("raw", raw, (torch.float32,), 2, dev)
    check_tensor("queries", queries, (torch.float32,), 2, dev)
    check_tensor("ids", ids, (torch.int32,), 1, dev)
    check_tensor("lanes", lanes, (torch.int32,), 1, dev)
    l2 = check_metric(metric)
    n, d = raw.shape
    nq = queries.shape[0]
    p = ids.shape[0]
    if queries.shape[1] != d or lanes.shape[0] != p:
        raise ValueError(f"queries must be (Q, {d}) and lanes ({p},), got "
                         f"{tuple(queries.shape)} and {tuple(lanes.shape)}")
    if (n == 0 or nq == 0) and p:
        raise ValueError("pairs into an empty corpus or query set")
    aligned = raw.data_ptr() % 16 == 0 and queries.data_ptr() % 16 == 0
    if route is None:
        route = plan(p, d, aligned=aligned)
    elif route not in rerank_fetch_cuda.routes or (
            route != "warp" and not persistent_rows(d, aligned)):
        raise ValueError(f"route {route!r} cannot take rows of d={d}"
                         f"{'' if aligned else ' off a 16-byte boundary'}")
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    if p == 0:
        return out
    lib = _build.load("rerank_fetch")
    ptrs = [raw.data_ptr(), ids.data_ptr(), queries.data_ptr(), lanes.data_ptr(),
            out.data_ptr()]
    if route == "warp":
        fn = lib.rerank_fetch_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        tail = [l2, vector_rows(raw)]
    else:
        fn = lib.rerank_fetch_regs_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        tail = [l2, launch_grid(p, d, route, dev)[0]]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, n, nq, d, p, *tail, stream)
    count_launch(rerank_fetch_cuda, route)
    _build.check(lib, "rerank_fetch", rc)
    return out


rerank_fetch_cuda.launches = 0  # kernel launches since the last reset
rerank_fetch_cuda.routes = {"regs": 0, "warp": 0}  # the same, by route
