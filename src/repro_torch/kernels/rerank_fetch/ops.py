"""Dispatch for the rerank-fetch kernel.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/rerank_fetch.cu``) or raises.
``use_kernel=False`` forces the plain version on any device.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._launch import check_metric, check_tensor, vector_rows
from .ref import fetch_rerank_pairs_ref


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


def rerank_fetch_cuda(raw, queries, ids, lanes, *, metric: str = "l2"):
    """Launch ``csrc/rerank_fetch.cu`` on the current stream. ``raw``
    (N, d) f32, ``queries`` (Q, d) f32, ``ids`` and ``lanes`` (P,) int32,
    all contiguous on one CUDA device."""
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
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    if p == 0:
        return out
    lib = _build.load("rerank_fetch")
    fn = lib.rerank_fetch_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(raw.data_ptr(), ids.data_ptr(), queries.data_ptr(),
                lanes.data_ptr(), out.data_ptr(), n, nq, d, p, l2,
                vector_rows(raw), stream)
    rerank_fetch_cuda.launches += 1
    _build.check(lib, "rerank_fetch", rc)
    return out


rerank_fetch_cuda.launches = 0  # kernel launches since the last reset
