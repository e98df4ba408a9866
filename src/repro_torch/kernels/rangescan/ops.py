"""Dispatch for the brute-force range scan.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/rangescan.cu``) or raises; a caller
that wants the plain version on the card calls ``rangescan_ref``. The
reference's ``use_pallas``, ``interpret``, ``block_q`` and ``block_n`` are
TPU concerns (the Pallas route, its CPU emulation, its VMEM blocks) and
have no counterpart here: the kernel picks its own tiles and masks ragged
edges, so nothing is padded.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils import INVALID_ID, cdiv, resolve_device
from .. import _build
from .._launch import ROW_DTYPES, check_metric, check_tensor, vector_rows
from .ref import rangescan_ref

_BLOCKS_PER_SM = 4   # blocks the N split aims for on each SM


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
            max_splits: int) -> tuple[int, int]:
    """(number of N splits, points per split): enough blocks to fill the
    card, each split a whole number of tiles."""
    tiles = cdiv(n, tile)
    want = max(1, cdiv(_BLOCKS_PER_SM * sms, cdiv(q, block_q)))
    split_len = cdiv(tiles, min(tiles, max_splits, want)) * tile
    return cdiv(n, split_len), split_len


def rangescan_cuda(queries, points, r, *, k: int = 128, metric: str = "l2"):
    """Launch ``csrc/rangescan.cu`` (a scan kernel and a merge kernel) on
    the current stream. ``queries`` (Q, d) f32 or bf16 (bf16 is widened to
    f32 here, exactly), ``points`` (N, d) f32 or bf16, both contiguous on
    one CUDA device; ``r`` a Python float (rounded to f32 as the reference
    rounds it); 1 <= k <= 256 (the kernel's ``rangescan_max_k``)."""
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
    lib = _build.load("rangescan")
    if not 1 <= k <= lib.rangescan_max_k():
        raise ValueError(f"k={k} outside the kernel's 1..{lib.rangescan_max_k()}")
    if isinstance(r, torch.Tensor):
        r = r.item()
    counts = torch.zeros((qn,), dtype=torch.int32, device=dev)
    if qn == 0 or n == 0:
        return (torch.full((qn, k), INVALID_ID, dtype=torch.int32, device=dev),
                torch.full((qn, k), float("inf"), device=dev), counts)
    ids = torch.empty((qn, k), dtype=torch.int32, device=dev)
    dists = torch.empty((qn, k), dtype=torch.float32, device=dev)
    queries = queries.float()
    small = int(qn <= lib.rangescan_block_queries(1))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, split_len = _splits(qn, n, lib.rangescan_block_queries(small),
                                 lib.rangescan_points_per_tile(), sms,
                                 lib.rangescan_max_splits())
    part_keys = torch.empty((qn, n_split, k), dtype=torch.int64, device=dev)
    part_n = torch.empty((qn, n_split), dtype=torch.int32, device=dev)
    fn = lib.rangescan_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(queries.data_ptr(), points.data_ptr(), ROW_DTYPES[points.dtype],
                float(r), qn, n, d, k, l2, small, vector_rows(points),
                n_split, split_len,
                counts.data_ptr(), part_keys.data_ptr(), part_n.data_ptr(),
                ids.data_ptr(), dists.data_ptr(), stream)
    rangescan_cuda.launches += 1
    _build.check(lib, "rangescan", rc)
    return ids, dists, counts


rangescan_cuda.launches = 0  # kernel launches (scan + merge) since the last reset
