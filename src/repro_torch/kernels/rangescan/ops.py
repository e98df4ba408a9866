"""Dispatch for the brute-force range scan.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/rangescan.cu``) or raises; a caller that
wants the plain version on the card calls ``rangescan_ref``. The kernel's
route depends on the shape, the dtype and the rows' alignment alone
(``plan``), never on a failure:

- ``wgmma``: rows TMA can address (d % 4 == 0 for f32 points, d % 8 == 0
  for bf16, on a 16-byte boundary): 3xTF32 products on the tensor cores,
  fed by TMA, with a query tile of 8 to 256 (the N of the products);
- ``simt``: the rest (d = 17, 33, ...): the f32 product on the CUDA cores.

The reference's ``use_pallas``, ``interpret``, ``block_q`` and ``block_n`` are
TPU concerns (the Pallas route, its CPU emulation, its VMEM blocks) and
have no counterpart here: the kernel picks its own tiles and masks ragged
edges, so nothing is padded.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ...utils import INVALID_ID, cdiv, resolve_device
from .. import _build
from .._launch import ROW_DTYPES, check_metric, check_tensor, count_launch, vector_rows
from .ref import rangescan_ref

TILE = 128                  # points a tile, both routes
MAX_SPLITS = 1024           # N splits (the merge's prefix sums)
MAX_K = 256
SIMT_BLOCK_Q = (8, 32)      # queries a SIMT block: Q <= 8, else
WGMMA_BLOCK_Q = (8, 16, 32, 64, 128, 256)   # the N of the wgmma route's products
H100_SMS = 132
_BLOCKS_PER_SM = 4          # SIMT blocks the N split aims for on each SM


class ScanPlan(NamedTuple):
    route: str        # "wgmma" or "simt"
    block_q: int      # queries a block holds
    q_tiles: int      # blocks along Q
    n_split: int      # blocks along N
    split_len: int    # points a split (a whole number of tiles)


def tma_rows(d: int, dtype: torch.dtype) -> bool:
    """Whether TMA can address (N, d) rows of ``dtype``: a row is a
    multiple of 16 bytes."""
    return d * torch.empty((), dtype=dtype).element_size() % 16 == 0


def blocks_per_sm(route: str, block_q: int) -> int:
    """Blocks of a route the N split aims for on each SM: the SIMT kernel's
    4; the wgmma kernel's 1 (its ring takes most of shared memory), 2 at
    the 8-query tile (whose short products leave one block's warps
    waiting). ``rangescan.cu`` holds the same numbers."""
    if route == "simt":
        return _BLOCKS_PER_SM
    return 2 if block_q == WGMMA_BLOCK_Q[0] else 1


def plan(q: int, n: int, d: int, dtype: torch.dtype, *, aligned: bool = True,
         sms: int = H100_SMS) -> ScanPlan:
    """The kernel's route and blocks for Q queries against (N, d) points of
    ``dtype`` whose base is (``aligned``) or is not on a 16-byte boundary:
    ``wgmma`` where TMA can address the rows, with the smallest query tile
    of ``WGMMA_BLOCK_Q`` that holds min(Q, 256) queries, or 128 above 256
    queries where tiles of 128 leave fewer empty slots; else ``simt``.
    Every (query, point) pair lies in exactly one block."""
    if q < 1 or n < 1:
        raise ValueError(f"nothing to scan: Q={q}, N={n}")
    if aligned and tma_rows(d, dtype):
        route = "wgmma"
        top = WGMMA_BLOCK_Q[-1]
        block_q = min(b for b in WGMMA_BLOCK_Q if b >= min(q, top))
        if q > top and cdiv(q, top // 2) * (top // 2) < cdiv(q, top) * top:
            block_q = top // 2
    else:
        route = "simt"
        block_q = SIMT_BLOCK_Q[0] if q <= SIMT_BLOCK_Q[0] else SIMT_BLOCK_Q[1]
    n_split, split_len = _splits(q, n, block_q, TILE, sms, MAX_SPLITS,
                                 blocks_per_sm(route, block_q))
    return ScanPlan(route, block_q, cdiv(q, block_q), n_split, split_len)


def rangescan(queries, points, r, *, k: int = 128, metric: str = "l2",
              device="cuda"):
    """Fused exact range scan: (ids (Q, k) int32, dists (Q, k) f32,
    counts (Q,) int32) for one scalar radius ``r``. Tensors stay on their
    device; numpy inputs go to ``device``."""
    if not isinstance(points, torch.Tensor):
        points = torch.as_tensor(np.asarray(points), device=resolve_device(device))
    if not isinstance(queries, torch.Tensor):
        queries = torch.as_tensor(np.asarray(queries), device=points.device)
    if points.device.type == "cpu":
        return rangescan_ref(queries, points, r, k=k, metric=metric)
    return rangescan_cuda(queries, points, r, k=k, metric=metric)


def _splits(q: int, n: int, block_q: int, tile: int, sms: int,
            max_splits: int, per_sm: int = _BLOCKS_PER_SM) -> tuple[int, int]:
    """(number of N splits, points per split): enough blocks to fill the
    card (``per_sm`` on each of ``sms``), each split a whole number of
    tiles."""
    tiles = cdiv(n, tile)
    want = max(1, cdiv(per_sm * sms, cdiv(q, block_q)))
    split_len = cdiv(tiles, min(tiles, max_splits, want)) * tile
    return cdiv(n, split_len), split_len


_CHECKED: set = set()


def _library():
    """The built library, its geometry checked once against this module's."""
    lib = _build.load("rangescan")
    if "geometry" not in _CHECKED:
        got = (lib.rangescan_points_per_tile(), lib.rangescan_max_splits(),
               lib.rangescan_max_k(), lib.rangescan_block_queries(1),
               lib.rangescan_block_queries(0),
               *(lib.rangescan_wgmma_blocks_per_sm(b) for b in WGMMA_BLOCK_Q))
        want = ((TILE, MAX_SPLITS, MAX_K) + SIMT_BLOCK_Q
                + tuple(blocks_per_sm("wgmma", b) for b in WGMMA_BLOCK_Q))
        if got != want:
            raise RuntimeError(f"rangescan.cu's geometry {got} is not ops.py's {want}")
        _CHECKED.add("geometry")
    return lib


def rangescan_cuda(queries, points, r, *, k: int = 128, metric: str = "l2",
                   route: str | None = None):
    """Launch ``csrc/rangescan.cu`` on the current stream: the route's scan
    (after a query pre-pass on ``wgmma``) and the merge. ``queries`` (Q, d)
    f32 or bf16 (bf16 is widened to f32 here, exactly), ``points`` (N, d)
    f32 or bf16, both contiguous on one CUDA device; ``r`` a Python float
    (rounded to f32 as the reference rounds it); 1 <= k <= 256. ``route``
    None takes ``plan``'s; naming one the shape does not allow raises (used
    to time both routes on one input). ``rangescan_cuda.launches`` counts
    calls and ``.routes`` the calls of each route."""
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"rangescan_cuda needs CUDA tensors, got {dev}")
    check_tensor("points", points, ROW_DTYPES, 2, dev)
    check_tensor("queries", queries, ROW_DTYPES, 2, dev)
    l2 = check_metric(metric)
    n, d = points.shape
    qn = queries.shape[0]
    if queries.shape[1] != d:
        raise ValueError(f"queries must be (Q, {d}), got {tuple(queries.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's 1..{MAX_K}")
    if isinstance(r, torch.Tensor):
        r = r.item()
    counts = torch.zeros((qn,), dtype=torch.int32, device=dev)
    if qn == 0 or n == 0:
        return (torch.full((qn, k), INVALID_ID, dtype=torch.int32, device=dev),
                torch.full((qn, k), float("inf"), device=dev), counts)
    lib = _library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the SIMT route takes any rows: the plan of rows TMA cannot address
    aligned = points.data_ptr() % 16 == 0 and route != "simt"
    p = plan(qn, n, d, points.dtype, aligned=aligned, sms=sms)
    if route not in (None, p.route):
        raise ValueError(f"route {route!r} cannot take {points.dtype} rows of {d} "
                         f"(plan: {p.route})")
    ids = torch.empty((qn, k), dtype=torch.int32, device=dev)
    dists = torch.empty((qn, k), dtype=torch.float32, device=dev)
    queries = queries.float()
    part_keys = torch.empty((qn, p.n_split, k), dtype=torch.int64, device=dev)
    part_n = torch.empty((qn, p.n_split), dtype=torch.int32, device=dev)
    out = [counts.data_ptr(), part_keys.data_ptr(), part_n.data_ptr(),
           ids.data_ptr(), dists.data_ptr()]
    if p.route == "wgmma":
        q_split = torch.empty((2, qn, cdiv(d, 32) * 32), dtype=torch.float32, device=dev)
        q_norm = torch.empty((qn,), dtype=torch.float32, device=dev)
        fn = lib.rangescan_wgmma_launch
        ints = [p.block_q, p.n_split, p.split_len]
        ptrs = [q_split.data_ptr(), q_norm.data_ptr()] + out
    else:
        fn = lib.rangescan_launch
        ints = [int(p.block_q == SIMT_BLOCK_Q[0]), vector_rows(points), p.n_split,
                p.split_len]
        ptrs = out
    ints = [qn, n, d, k, l2] + ints
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * len(ints) + [ctypes.c_void_p] * (len(ptrs) + 1))
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(queries.data_ptr(), points.data_ptr(), ROW_DTYPES[points.dtype], float(r),
                *ints, *ptrs, torch.cuda.current_stream(dev).cuda_stream)
    count_launch(rangescan_cuda, p.route)
    _build.check(lib, "rangescan", rc)
    return ids, dists, counts


rangescan_cuda.launches = 0  # calls that launched the kernels, since the last reset
rangescan_cuda.routes = {"wgmma": 0, "simt": 0}  # the same, by route
